// K2 — frame (temporal) attention, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces: mvoc_tpu/ops/attention.py `frame_attention` / `_frame_kernel`
// (the Pallas TPU kernel; pl.pallas_call at ops/attention.py:270).
//
// Function: for every (batch b, pixel s, head h), self-attention across the
// F frames: logits = (q . k) * 1/sqrt(D) in fp32 (+ an optional [F, F]
// additive band bias of 0 / -1e30), max-subtracted softmax in fp32,
// p normalised and THEN rounded to the input dtype, out = p . v with fp32
// accumulation, cast to the input dtype.
//
// What bounds it on the H100: per (pixel, head) it does 4*F*F*D operations
// on 4*F*D elements of I/O — F = 16 gives 8 operations per byte in bf16,
// far below the ~295 where the tensor cores become the limit.  It is bound
// by HBM: 4 * B*F*S*H*D * sizeof(dtype) bytes at 3.35 TB/s.  Both designs
// read each element once, in place, with no pack/unpack transposes (the
// TPU kernel packs heads into g*F <= 128 row groups with a block-diagonal
// -1e30 bias to fill the 128x128 MXU, ops/attention.py:238-248, unpacked
// at :290-294; here each head is computed on its own).  Element (b, f, s,
// h, d) sits at b*sb + f*sf + s*ss + h*D + d: the natural layout
// [B, F, S, H*D] and the pixel-major ("sf") layout [S, F, H*D] are the same
// kernel with the frame and pixel strides swapped.
//
// Variants, chosen by the wrapper from (dtype, D), the same every time:
//  * mma (bf16, D = 64; every UNet temporal or frame-axis call).  One
//    (pixel, head) unit is an F x 64 tile of q, k and v, and a D = 64 bf16
//    row is one contiguous 128-byte line in both layouts.  A work item is
//    one 16-row query tile of a unit (at F <= 16 the whole unit; at F = 64
//    four items, so a unit's four query tiles run on four warps at once).
//    Each warp walks its items (4 warps a block, a grid-stride loop over
//    items in the order query tile, h, s, b, so the items in flight at once
//    are neighbours in memory) and copies the next item's q lines and its
//    unit's k, v lines by cp.async in 16-byte pieces, consecutive lanes on
//    consecutive pieces, while it computes this one (two stages a warp at
//    F <= 16; one above, so that more warps share an SM).
//    The tiles sit in shared
//    memory in the 128-byte swizzle (chunk c of row r at c ^ (r % 8)), so
//    the ldmatrix reads below are free of bank conflicts.  F is padded to
//    FP = 16 * ceil(F / 16) rows: padded rows are zero-filled by the copy,
//    padded key columns get -1e30 and padded query rows are never stored.
//    Logits S = Q K^T are computed once, by mma.sync.m16n8k16 (bf16 in,
//    fp32 out; ldmatrix for Q, ldmatrix for K as the "col" B operand);
//    scale and bias (an [FP, FP] fp32 table in shared
//    memory: the band, 0, or -1e30 on padded columns) are applied on the
//    accumulator fragment; row max and sum reduce over the 4 lanes of a
//    row by shuffles; p is normalised, rounded to bf16 and packed in place
//    into the A fragment of O = P V (the accumulator layout is the A
//    layout), whose B operand is V through ldmatrix.trans.  O goes back
//    through the q tile's shared memory and leaves in 16-byte stores, whole
//    128-byte lines.  The tensor cores are there to take the logits off the
//    FP32 pipes and the shared-memory port that the SIMT design's three
//    recomputing passes saturate, not to reach their own peak; wgmma's
//    64-row tile would be 3/4 block-diagonal waste at F = 16.
//  * simt (fp32, and bf16 at D = 4; its bf16 D = 64 instantiation serves
//    side-by-side timing only): one block = PX = 128 / F pixels x one head;
//    it stages the PX*F rows of K and V in shared memory, then each thread
//    owns one (pixel, query frame) pair, its q row and its D outputs in
//    registers, and recomputes the F logits in three short passes (max,
//    sum, p.v).  fp32 stays exact fp32 this way (tensor cores would take it
//    to TF32).
//
// F may be 1..64; D in {4, 64}: 64 for every UNet temporal or frame-axis
// call, 4 for the image-latents temporal encoder.  The mma variant needs
// 16-byte aligned rows (the wrapper checks the pointers and strides).

#include "common.cuh"
#include "hopper.cuh"

namespace mvoc {

constexpr int kFrameThreads = 128;
constexpr int kMaxFrames = 64;

template <typename T, int D>
__device__ __forceinline__ float dot_row(const float* qr, const T* krow) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) acc += qr[d] * to_f<T>(krow[d]);
  return acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(kFrameThreads)
frame_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, const float* __restrict__ bias, int F, int S,
             int64_t sb, int64_t sf, int64_t ss, int64_t osb, int64_t osf, int64_t oss,
             float scale) {
  const int PX = kFrameThreads / F;  // pixels per block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [PX][F][D]
  T* Vs = Ks + PX * F * D;                 // [PX][F][D]

  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * PX;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t base = b * sb + static_cast<int64_t>(h) * D;

  for (int e = tid; e < PX * F * D; e += kFrameThreads) {
    const int pp = e / (F * D);
    const int g = (e / D) % F;
    const int d = e % D;
    const int s = s0 + pp;
    T kv = from_f<T>(0.f), vv = from_f<T>(0.f);
    if (s < S) {
      const int64_t off = base + g * sf + s * ss + d;
      kv = k[off];
      vv = v[off];
    }
    Ks[e] = kv;
    Vs[e] = vv;
  }
  __syncthreads();

  const int p = tid / F, f = tid % F;
  const int s = s0 + p;
  if (p >= PX || s >= S) return;
  const int64_t qoff = base + f * sf + s * ss;
  const int64_t ooff = b * osb + static_cast<int64_t>(h) * D + f * osf + s * oss;
  const T* kb = Ks + p * F * D;
  const T* vb = Vs + p * F * D;
  const float* brow = bias == nullptr ? nullptr : bias + f * F;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = to_f<T>(q[qoff + d]);

  float mx = kNegBig;
  for (int g = 0; g < F; ++g) {
    float x = dot_row<T, D>(qr, kb + g * D) * scale;
    if (brow != nullptr) x += brow[g];
    mx = fmaxf(mx, x);
  }
  float sum = 0.f;
  for (int g = 0; g < F; ++g) {
    float x = dot_row<T, D>(qr, kb + g * D) * scale;
    if (brow != nullptr) x += brow[g];
    sum += expf(x - mx);
  }
  float out[D];
#pragma unroll
  for (int d = 0; d < D; ++d) out[d] = 0.f;
  for (int g = 0; g < F; ++g) {
    float x = dot_row<T, D>(qr, kb + g * D) * scale;
    if (brow != nullptr) x += brow[g];
    const float pg = round_to<T>(expf(x - mx) / sum);  // normalised, then cast
    const T* vrow = vb + g * D;
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] += pg * to_f<T>(vrow[d]);
  }
#pragma unroll
  for (int d = 0; d < D; ++d) o[ooff + d] = from_f<T>(out[d]);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const float* bias,
                   int B, int F, int S, int H, const long long* st, float scale,
                   cudaStream_t stream) {
  const int PX = kFrameThreads / F;
  auto kernel = frame_kernel<T, D>;
  const size_t smem = sizeof(T) * 2 * PX * F * D;
  cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (H > 65535 || B > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid(static_cast<unsigned>((S + PX - 1) / PX), H, B);
  kernel<<<grid, kFrameThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), bias, F, S, st[0], st[1], st[2], st[3], st[4], st[5], scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simt_d(const void* q, const void* k, const void* v, void* o, const float* bias,
                          int B, int F, int S, int H, int D, const long long* st, float scale,
                          cudaStream_t stream) {
  switch (D) {
    case 4: return launch<T, 4>(q, k, v, o, bias, B, F, S, H, st, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, bias, B, F, S, H, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ===========================================================================
// mma variant: bf16, D = 64, on the tensor cores through mma.sync
// ===========================================================================

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;
constexpr float kLog2e = 1.4426950408889634f;

// NF 16-row tiles of frames: F padded to FP = 16 * NF.  A work item is
// one 16-row query tile of one unit: per warp, STAGES stages of the item's
// q rows and the unit's FP rows of k and v (128 bytes each); the [FP, FP]
// bias table first.  At F <= 16 (the main path: many items a warp) the
// next item's copies overlap this one's products; above, one stage a warp
// lets 2-5 blocks share an SM, which the few items of those calls need more.
template <int NF>
struct FrameMma {
  static constexpr int FP = 16 * NF;
  static constexpr int STAGES = NF == 1 ? 2 : 1;
  static constexpr int QTILE = 16 * 128;
  static constexpr int TILE = FP * 128;
  static constexpr int STAGE = QTILE + 2 * TILE;
  static constexpr int WARP = STAGES * STAGE;
  static constexpr int BIAS = FP * FP * 4;
  static constexpr size_t smem = BIAS + kMmaWarps * WARP;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, fp32 accumulate.  c0/c1 at
// (row g, col 2t / 2t+1), c2/c3 at row g + 8; a0 (row g, k 2t..), a1 (row
// g + 8), a2 (k + 8), a3 (row g + 8, k + 8); b0 (k 2t.., col g), b1 (k + 8).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct FrameArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const float* bias;  // [F, F] or nullptr
  int F, S, H;
  long long units;       // B * S * H
  long long items;       // units * NF: (unit, 16-row query tile) pairs
  int64_t sb, sf, ss;     // q, k, v (elements)
  int64_t osb, osf, oss;  // o
  float scale;
};

// The element offset of unit u = (b * S + s) * H + h, frame 0, in q / k / v
// (out = false) or in o (out = true).
__device__ __forceinline__ int64_t unit_base(const FrameArgs& a, long long u, bool out) {
  const long long bs = u / a.H;
  const int h = static_cast<int>(u - bs * a.H);
  const long long b = bs / a.S;
  const long long s = bs - b * a.S;
  return b * (out ? a.osb : a.sb) + s * (out ? a.oss : a.ss) + static_cast<int64_t>(h) * 64;
}

// cp.async one item into a stage: q rows 16 mt .. 16 mt + 15 of unit u,
// and all F rows of its k and v (rows past F, and every row of an item past
// the end, zero-filled); lane-consecutive 16-byte pieces, whole 128-byte
// lines.
template <int NF>
__device__ __forceinline__ void load_item(unsigned char* stage, const FrameArgs& a,
                                          long long item, int lane) {
  using C = FrameMma<NF>;
  const bool live = item < a.items;
  const int mt = static_cast<int>(item % NF);
  const int64_t base = live ? unit_base(a, item / NF, false) : 0;
#pragma unroll
  for (int i = 0; i < 16 * 8 / 32; ++i) {
    const int c = lane + 32 * i;
    const int r = c >> 3, ch = c & 7, f = 16 * mt + r;
    const bool ok = live && f < a.F;
    cp_async_16(stage + sw128(r, ch), a.q + base + (ok ? f * a.sf + ch * 8 : 0), ok ? 16 : 0);
  }
  const bf16* src[2] = {a.k + base, a.v + base};
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int i = 0; i < C::FP * 8 / 32; ++i) {
      const int c = lane + 32 * i;
      const int r = c >> 3, ch = c & 7;
      const bool ok = live && r < a.F;
      cp_async_16(stage + C::QTILE + t * C::TILE + sw128(r, ch),
                  src[t] + (ok ? r * a.sf + ch * 8 : 0), ok ? 16 : 0);
    }
  }
}

template <int NF>
__global__ void __launch_bounds__(kMmaWarps * 32) frame_mma_kernel(const FrameArgs a) {
  using C = FrameMma<NF>;
  constexpr int FP = C::FP;
  extern __shared__ __align__(128) unsigned char smem_fm[];
  float* Bs = reinterpret_cast<float*>(smem_fm);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  unsigned char* wbuf = smem_fm + C::BIAS + warp * C::WARP;

  const long long wid = static_cast<long long>(blockIdx.x) * kMmaWarps + warp;
  const long long nwarps = static_cast<long long>(gridDim.x) * kMmaWarps;
  long long item = wid;
  load_item<NF>(wbuf, a, item, lane);
  cp_async_commit();

  // scale and mask per logit: the band (or 0) on real columns, -1e30 on padded ones
  for (int e = tid; e < FP * FP; e += kMmaWarps * 32) {
    const int r = e / FP, c = e % FP;
    float x = kNegBig;
    if (c < a.F) x = (a.bias != nullptr && r < a.F) ? a.bias[r * a.F + c] : 0.f;
    Bs[e] = x;
  }
  __syncthreads();

  for (int it = 0; item < a.items; ++it, item += nwarps) {
    unsigned char* cur = wbuf + (it % C::STAGES) * C::STAGE;
    if constexpr (C::STAGES == 2) {
      load_item<NF>(wbuf + ((it + 1) & 1) * C::STAGE, a, item + nwarps, lane);
      cp_async_commit();
      cp_async_wait<1>();  // this lane's copies of this item
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // ... and every lane's
    const uint32_t qs = smem_u32(cur), ks = qs + C::QTILE, vs = ks + C::TILE;
    const int mt = static_cast<int>(item % NF);
    bf16* op = a.o + unit_base(a, item / NF, true);

    float s[2 * NF][4];
#pragma unroll
    for (int j = 0; j < 2 * NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // D = 64: four k16 steps
      uint32_t qa[4];
      ldsm_x4(qa, qs + sw128(lane & 15, 2 * kk + (lane >> 4)));
#pragma unroll
      for (int np = 0; np < NF; ++np) {  // 16 keys: two n8 tiles
        uint32_t kb[4];
        ldsm_x4(kb, ks + sw128(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                               2 * kk + ((lane >> 3) & 1)));
        mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }
    // fp32 logits * scale + bias, then the max-subtracted softmax of the
    // query rows 16 mt + g and 16 mt + g + 8 (e >> 1 picks the row)
    const int r0 = mt * 16 + g;
    float mx[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int j = 0; j < 2 * NF; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 b = *reinterpret_cast<const float2*>(Bs + (r0 + 8 * h) * FP + 8 * j + 2 * t);
        s[j][2 * h] = s[j][2 * h] * a.scale + b.x;
        s[j][2 * h + 1] = s[j][2 * h + 1] * a.scale + b.y;
        mx[h] = fmaxf(mx[h], fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
#pragma unroll
    for (int j = 0; j < 2 * NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_ftz((s[j][e] - mx[e >> 1]) * kLog2e);
        s[j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    }
    // p / sum rounded to bf16, packed in place as the A fragments of P V
    uint32_t pa[NF][4];
#pragma unroll
    for (int kk = 0; kk < NF; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0] / sum[0], s[2 * kk][1] / sum[0]);
      pa[kk][1] = pack_bf16(s[2 * kk][2] / sum[1], s[2 * kk][3] / sum[1]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0] / sum[0], s[2 * kk + 1][1] / sum[0]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2] / sum[1], s[2 * kk + 1][3] / sum[1]);
    }
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NF; ++kk) {  // 16 keys a step
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {  // 16 columns of D: two n8 tiles
        uint32_t vb[4];
        ldsm_x4_trans(vb, vs + sw128(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                     2 * dp + (lane >> 4)));
        mma_bf16(o[2 * dp], pa[kk], vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa[kk], vb[2], vb[3]);
      }
    }
    // O through the q tile (read by no one now), then out in 16-byte
    // pieces, whole lines, frames < F only
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(cur + sw128(g + 8 * h, j) + 4 * t) =
            pack_bf16(o[j][2 * h], o[j][2 * h + 1]);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane + 32 * i;
      const int r = c >> 3, ch = c & 7, f = mt * 16 + r;
      if (f < a.F)
        *reinterpret_cast<uint4*>(op + f * a.osf + ch * 8) =
            *reinterpret_cast<const uint4*>(cur + sw128(r, ch));
    }
    __syncwarp();  // this stage is consumed before the next copy into it
    if constexpr (C::STAGES == 1) {
      load_item<NF>(wbuf, a, item + nwarps, lane);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
}

template <int NF>
cudaError_t launch_mma_nf(FrameArgs a, cudaStream_t stream) {
  a.items = a.units * NF;
  using C = FrameMma<NF>;
  auto kernel = frame_mma_kernel<NF>;
  cudaError_t err = prepare_smem(kernel, C::smem);
  if (err != cudaSuccess) return err;
  // a grid-stride loop: as many blocks as fit on the card at once, fewer
  // when there are fewer items than warps
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaWarps * 32, C::smem);
    if (err != cudaSuccess) return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long need = (a.items + kMmaWarps - 1) / kMmaWarps;
  const unsigned grid = static_cast<unsigned>(need < resident ? need : resident);
  kernel<<<grid, kMmaWarps * 32, C::smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, const float* bias,
                       int B, int F, int S, int H, int D, const long long* st, float scale,
                       cudaStream_t stream) {
  if (D != 64) return cudaErrorInvalidValue;
  const FrameArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(o), bias, F, S, H,
                    static_cast<long long>(B) * S * H, 0, st[0], st[1], st[2], st[3], st[4],
                    st[5], scale};
  switch ((F + 15) / 16) {
    case 1: return launch_mma_nf<1>(a, stream);
    case 2: return launch_mma_nf<2>(a, stream);
    case 3: return launch_mma_nf<3>(a, stream);
    case 4: return launch_mma_nf<4>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mvoc

// variant: 0 SIMT (fp32 or bf16; D 4 or 64), 1 mma (bf16, D 64).
// strides: 6 values, (batch, frame, pixel) in elements, shared by q, k and
// v, then o's; the H*D channel run of one (b, f, s) row must be contiguous,
// and for the mma variant every row 16-byte aligned (the wrapper checks).  bias: optional
// [F, F] fp32 additive mask (nullptr = none).  Returns a cudaError_t.
extern "C" int mvoc_frame_attention(const void* q, const void* k, const void* v, void* o,
                                    const void* bias, int variant, int dtype, int B, int F,
                                    int S, int H, int D, const long long* strides, float scale,
                                    void* stream) {
  using namespace mvoc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || F <= 0 || S <= 0 || H <= 0 || F > kMaxFrames) return cudaErrorInvalidValue;
  const float* bf = static_cast<const float*>(bias);
  if (variant == 0) {
    switch (dtype) {
      case kF32: return launch_simt_d<float>(q, k, v, o, bf, B, F, S, H, D, strides, scale, s);
      case kBF16:
        return launch_simt_d<__nv_bfloat16>(q, k, v, o, bf, B, F, S, H, D, strides, scale, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (variant != 1 || dtype != kBF16) return cudaErrorInvalidValue;
  return launch_mma(q, k, v, o, bf, B, F, S, H, D, strides, scale, s);
}
