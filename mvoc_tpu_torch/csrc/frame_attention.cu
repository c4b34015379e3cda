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
// on 4*F*D elements of I/O — F = 16 gives 16 operations per element, far
// below the ~300 operations per byte where the tensor cores become the
// limit.  It is bound by HBM: 4 * B*F*S*H*D * sizeof(dtype) bytes at
// 3.35 TB/s.  The design therefore reads each element once, in place:
//
//   * no pack/unpack transposes.  The TPU kernel packs heads into g*F <= 128
//     row groups with a block-diagonal -1e30 bias to fill the 128x128 MXU
//     (ops/attention.py:238-248, unpacked again at :290-294) — two HBM
//     copies of q/k/v/o.  Here each head is computed on its own and the
//     kernel walks the tensor by strides: element (b, f, s, h, d) sits at
//     b*sb + f*sf + s*ss + h*D + d.  The natural layout [B, F, S, H*D] and
//     the pixel-major ("sf") layout [S, F, H*D] are the same kernel with
//     the frame and pixel strides swapped.
//   * one block = PX = 128 / F pixels x one head; it stages the PX*F rows of
//     K and V in shared memory with coalesced loads (a row is a contiguous
//     D run), then each thread owns one (pixel, query frame) pair: its q row
//     and its D outputs stay in registers.  The F logits are recomputed in
//     three short passes (max, sum, then p.v) instead of being held in a
//     per-thread array, so the frame count is a runtime value and only the
//     head dim is a template parameter: the file builds in seconds (a
//     version templated on the frame count took minutes to compile).
//
// F may be 1..64; D in {4, 64}: 64 for every UNet temporal or frame-axis
// call, 4 for the image-latents temporal encoder.  Another head dim is one
// more case in dispatch_d (and in FRAME_HEAD_DIMS) when a caller needs it.

#include "common.cuh"

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
             int64_t sb, int64_t sf, int64_t ss, float scale) {
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
  for (int d = 0; d < D; ++d) o[qoff + d] = from_f<T>(out[d]);
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
      static_cast<T*>(o), bias, F, S, st[0], st[1], st[2], scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, const float* bias,
                       int B, int F, int S, int H, int D, const long long* st, float scale,
                       cudaStream_t stream) {
  if (F > kMaxFrames) return cudaErrorInvalidValue;
  switch (D) {
    case 4: return launch<T, 4>(q, k, v, o, bias, B, F, S, H, st, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, bias, B, F, S, H, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mvoc

// strides: (batch, frame, pixel) in elements, shared by q, k, v and o; the
// H*D channel run of one (b, f, s) row must be contiguous.  bias: optional
// [F, F] fp32 additive mask (nullptr = none).  Returns a cudaError_t.
extern "C" int mvoc_frame_attention(const void* q, const void* k, const void* v, void* o,
                                    const void* bias, int dtype, int B, int F, int S, int H,
                                    int D, const long long* strides, float scale,
                                    void* stream) {
  using namespace mvoc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || F <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  const float* bf = static_cast<const float*>(bias);
  switch (dtype) {
    case kF32: return dispatch_d<float>(q, k, v, o, bf, B, F, S, H, D, strides, scale, s);
    case kBF16: return dispatch_d<__nv_bfloat16>(q, k, v, o, bf, B, F, S, H, D, strides, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
