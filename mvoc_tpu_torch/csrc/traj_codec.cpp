// Native trajectory codec of mvoc_tpu_torch (host C++, bound by ctypes in
// io/native.py; the port's own copy of the JAX package's codec, so that
// both packages read and write the same container).
//
// The reference serializes one torch .pt file per inversion step (500 files,
// ~3.5 GB per video, reference: pipeline_i2vgen_xl.py:1988-1996).  The
// trajectory store keeps the whole trajectory in ONE container; this codec
// does its host-side work:
//
//   * fp32 -> fp16 conversion on write, fp16 -> fp32 on read (multithreaded)
//   * a flat mmap-able container (magic/header/timesteps/payload), so the
//     composite can gather any subset of steps without reading the rest
//
// File layout (little endian):
//   [0]  u64 magic = 0x4D564F4354524131 ("MVOCTRA1")
//   [8]  u32 n_steps, u32 n_dims
//   [16] u32 dims[n_dims]
//   [..] i32 timesteps[n_steps]
//   [..] u16 payload[n_steps * prod(dims)]   (IEEE fp16)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <functional>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint64_t kMagic = 0x4D564F4354524131ULL;

inline uint16_t f32_to_f16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000u;
  int32_t exp = (int32_t)((x >> 23) & 0xFF) - 127 + 15;
  uint32_t mant = x & 0x7FFFFFu;
  if (exp <= 0) {
    if (exp < -10) return (uint16_t)sign;  // underflow -> signed zero
    mant |= 0x800000u;                      // subnormal
    uint32_t shift = (uint32_t)(14 - exp);
    uint32_t half_mant = mant >> shift;
    // round to nearest even
    uint32_t rem = mant & ((1u << shift) - 1);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half_mant & 1))) half_mant++;
    return (uint16_t)(sign | half_mant);
  }
  if (exp >= 31) return (uint16_t)(sign | 0x7C00u);  // inf/overflow
  uint32_t half = sign | ((uint32_t)exp << 10) | (mant >> 13);
  uint32_t rem = mant & 0x1FFFu;
  if (rem > 0x1000u || (rem == 0x1000u && (half & 1))) half++;
  return (uint16_t)half;
}

inline float f16_to_f32(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t mant = h & 0x3FFu;
  uint32_t x;
  if (exp == 0) {
    if (mant == 0) {
      x = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while (!(mant & 0x400u)) {
        mant <<= 1;
        exp--;
      }
      mant &= 0x3FFu;
      x = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    x = sign | 0x7F800000u | (mant << 13);
  } else {
    x = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}

void parallel_for(size_t n, unsigned max_threads,
                  const std::function<void(size_t, size_t)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  unsigned nt = hw ? hw : 1;
  if (max_threads && nt > max_threads) nt = max_threads;
  if (nt <= 1 || n < (1u << 16)) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  size_t chunk = (n + nt - 1) / nt;
  for (unsigned i = 0; i < nt; i++) {
    size_t lo = i * chunk;
    size_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    ts.emplace_back(fn, lo, hi);
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// bulk converters (usable standalone)
void mvoc_f32_to_f16(const float* src, uint16_t* dst, uint64_t n) {
  parallel_for(n, 0, [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; i++) dst[i] = f32_to_f16(src[i]);
  });
}

void mvoc_f16_to_f32(const uint16_t* src, float* dst, uint64_t n) {
  parallel_for(n, 0, [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; i++) dst[i] = f16_to_f32(src[i]);
  });
}

// Write a trajectory container from fp32 data. Returns 0 on success.
int mvoc_traj_write(const char* path, const int32_t* timesteps,
                    uint32_t n_steps, const uint32_t* dims, uint32_t n_dims,
                    const float* data) {
  uint64_t per_step = 1;
  for (uint32_t i = 0; i < n_dims; i++) per_step *= dims[i];
  uint64_t n = (uint64_t)n_steps * per_step;
  uint64_t header = 16 + 4ull * n_dims + 4ull * n_steps;
  uint64_t total = header + 2ull * n;

  int fd = ::open(path, O_RDWR | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  if (ftruncate(fd, (off_t)total) != 0) {
    ::close(fd);
    return -2;
  }
  void* map = mmap(nullptr, total, PROT_WRITE | PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return -3;
  }
  auto* p = (uint8_t*)map;
  std::memcpy(p, &kMagic, 8);
  std::memcpy(p + 8, &n_steps, 4);
  std::memcpy(p + 12, &n_dims, 4);
  std::memcpy(p + 16, dims, 4ull * n_dims);
  std::memcpy(p + 16 + 4ull * n_dims, timesteps, 4ull * n_steps);
  auto* payload = (uint16_t*)(p + header);
  mvoc_f32_to_f16(data, payload, n);
  munmap(map, total);
  ::close(fd);
  return 0;
}

struct TrajHandle {
  int fd;
  uint8_t* map;
  uint64_t total;
  uint32_t n_steps;
  uint32_t n_dims;
  const uint32_t* dims;
  const int32_t* timesteps;
  const uint16_t* payload;
  uint64_t per_step;
};

void* mvoc_traj_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* p = (uint8_t*)map;
  uint64_t magic;
  std::memcpy(&magic, p, 8);
  if (magic != kMagic) {
    munmap(map, (size_t)st.st_size);
    ::close(fd);
    return nullptr;
  }
  auto* h = new TrajHandle();
  h->fd = fd;
  h->map = p;
  h->total = (uint64_t)st.st_size;
  std::memcpy(&h->n_steps, p + 8, 4);
  std::memcpy(&h->n_dims, p + 12, 4);
  h->dims = (const uint32_t*)(p + 16);
  h->timesteps = (const int32_t*)(p + 16 + 4ull * h->n_dims);
  h->payload = (const uint16_t*)(p + 16 + 4ull * h->n_dims + 4ull * h->n_steps);
  h->per_step = 1;
  for (uint32_t i = 0; i < h->n_dims; i++) h->per_step *= h->dims[i];
  return h;
}

uint32_t mvoc_traj_n_steps(void* vh) { return ((TrajHandle*)vh)->n_steps; }
uint32_t mvoc_traj_n_dims(void* vh) { return ((TrajHandle*)vh)->n_dims; }

void mvoc_traj_meta(void* vh, uint32_t* dims, int32_t* timesteps) {
  auto* h = (TrajHandle*)vh;
  std::memcpy(dims, h->dims, 4ull * h->n_dims);
  std::memcpy(timesteps, h->timesteps, 4ull * h->n_steps);
}

// Gather `count` steps (by index) into fp32 out [count, per_step].
int mvoc_traj_gather(void* vh, const uint32_t* step_indices, uint32_t count,
                     float* out) {
  auto* h = (TrajHandle*)vh;
  for (uint32_t i = 0; i < count; i++) {
    if (step_indices[i] >= h->n_steps) return -1;
  }
  parallel_for(count, 0, [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; i++) {
      const uint16_t* src = h->payload + (uint64_t)step_indices[i] * h->per_step;
      float* dst = out + (uint64_t)i * h->per_step;
      for (uint64_t j = 0; j < h->per_step; j++) dst[j] = f16_to_f32(src[j]);
    }
  });
  return 0;
}

void mvoc_traj_close(void* vh) {
  auto* h = (TrajHandle*)vh;
  munmap(h->map, h->total);
  ::close(h->fd);
  delete h;
}

}  // extern "C"
