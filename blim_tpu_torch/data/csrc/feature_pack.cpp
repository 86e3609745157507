// feature_pack.cpp — native reader for the packed video-feature cache.
//
// The reference's data layer opens one torch .pth file per video per access
// (reference: dataloader/base_dataset.py:26-31). blim_tpu packs all features
// into one contiguous file (data/features.py write_pack); this library mmaps
// the pack once and serves batched gathers (index list -> contiguous fp32
// buffer) with multithreaded fp16->fp32 conversion, so feeding the TPU
// rerank engine never bottlenecks on Python file IO.
//
// Build:  g++ -O3 -march=native -shared -fPIC -pthread -o libfeature_pack.so feature_pack.cpp
// ABI: plain C, consumed via ctypes (blim_tpu/data/native_pack.py).

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Pack {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t file_size = 0;
  int64_t n_items = 0;
  int64_t item_elems = 0;   // elements per item
  int dtype = 0;            // 0 = fp16, 1 = fp32
};

inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t mant = h & 0x3ff;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {  // subnormal: normalize
      // subnormal value = m * 2^-24; normalized: 1.f * 2^(-14 - shift)
      int shift = 0;
      while (!(mant & 0x400)) { mant <<= 1; ++shift; }
      mant &= 0x3ff;
      bits = sign | ((127 - 14 - shift) << 23) | (mant << 13);
    }
  } else if (exp == 0x1f) {
    bits = sign | 0x7f800000u | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float out;
  std::memcpy(&out, &bits, sizeof(out));
  return out;
}

void convert_range(const Pack* p, const int64_t* indices, int64_t lo, int64_t hi,
                   float* out) {
  const int64_t elems = p->item_elems;
  for (int64_t i = lo; i < hi; ++i) {
    int64_t idx = indices[i];
    float* dst = out + i * elems;
    if (idx < 0 || idx >= p->n_items) {  // missing video -> zero fallback
      std::memset(dst, 0, elems * sizeof(float));
      continue;
    }
    if (p->dtype == 1) {
      const float* src = reinterpret_cast<const float*>(p->base) + idx * elems;
      std::memcpy(dst, src, elems * sizeof(float));
    } else {
      const uint16_t* src = reinterpret_cast<const uint16_t*>(p->base) + idx * elems;
      for (int64_t e = 0; e < elems; ++e) dst[e] = half_to_float(src[e]);
    }
  }
}

}  // namespace

extern "C" {

// Open a pack file. dtype: 0 fp16, 1 fp32. Returns handle or null.
void* pack_open(const char* path, int64_t n_items, int64_t item_elems, int dtype) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  size_t elem_size = dtype == 1 ? 4 : 2;
  if ((size_t)st.st_size < (size_t)(n_items * item_elems * elem_size)) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) { ::close(fd); return nullptr; }
  madvise(base, st.st_size, MADV_WILLNEED);
  Pack* p = new Pack();
  p->fd = fd;
  p->base = static_cast<const uint8_t*>(base);
  p->file_size = st.st_size;
  p->n_items = n_items;
  p->item_elems = item_elems;
  p->dtype = dtype;
  return p;
}

// Gather `count` items by index into `out` (count * item_elems floats).
// Negative indices write zeros (missing-feature fallback).
void pack_gather(void* handle, const int64_t* indices, int64_t count, float* out,
                 int n_threads) {
  Pack* p = static_cast<Pack*>(handle);
  if (n_threads <= 1 || count < 4) {
    convert_range(p, indices, 0, count, out);
    return;
  }
  std::vector<std::thread> threads;
  int64_t per = (count + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * per;
    int64_t hi = std::min(count, lo + per);
    if (lo >= hi) break;
    threads.emplace_back(convert_range, p, indices, lo, hi, out);
  }
  for (auto& th : threads) th.join();
}

void pack_close(void* handle) {
  Pack* p = static_cast<Pack*>(handle);
  if (p == nullptr) return;
  munmap(const_cast<uint8_t*>(p->base), p->file_size);
  ::close(p->fd);
  delete p;
}

}  // extern "C"
