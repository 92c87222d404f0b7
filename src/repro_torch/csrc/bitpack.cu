// Fixed-width b-bit pack and unpack, MSB-first into 32-bit words.
//
// Replaces the TPU kernels src/repro/kernels/bitpack/kernel.py::pack (:46)
// and ::unpack (:65), for b in {2, 4, 8, 16} and per = 32/b values a word:
//
//   word = OR_k ((v_k & (2^b - 1)) << (32 - b(k+1)))     k = 0 .. per-1
//   v_k  = (word >> (32 - b(k+1))) & (2^b - 1)
//
// One kernel serves both layouts the port uses, templated on the stride
// between the per values of one word:
//   * STRIDE 128, the TPU kernel's tile layout: values (R, per, 128),
//     words (R, 128), word (r, l) holds v[r, k, l]. Adjacent threads take
//     adjacent lanes, so every load and store is coalesced;
//   * STRIDE 1, the wire layout of the fixed-width collectives (the
//     reference's grad_compress.py::pack_jnp/unpack_jnp): word i holds
//     q[i*per .. i*per+per-1]. A thread moves its per values with 8- or
//     16-byte vector accesses when the pointer is aligned.
// Values past n_vals read as 0, so a partial tail word is zero-padded by
// the kernel (the flat wrappers need no padded copy of their input), and
// unpack writes only the first n_vals values.
//
// Bound on the H100: bytes. pack reads 4 B a value and writes b/8 B;
// unpack the reverse; the work is a shift, mask and OR a value (no carry
// between words). Design: one thread per word, a grid-stride loop, no
// shared memory. Making it fast (several words a thread, fusing the
// quantize into the pack) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 65535LL * 16;

inline unsigned grid_for(int64_t n) {
  int64_t b = (n + THREADS - 1) / THREADS;
  return static_cast<unsigned>(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

// first value of word w, and the word's value k at base + k * STRIDE
template <int PER, int STRIDE>
__device__ __forceinline__ int64_t word_base(int64_t w) {
  if constexpr (STRIDE == 1) return w * PER;
  else
    return (w / STRIDE) * (PER * STRIDE) + (w % STRIDE);
}

template <int PER>
__device__ __forceinline__ void load_vec(const int32_t* p, int32_t (&v)[PER]) {
  if constexpr (PER % 4 == 0) {
#pragma unroll
    for (int j = 0; j < PER; j += 4) {
      int4 t = *reinterpret_cast<const int4*>(p + j);
      v[j] = t.x; v[j + 1] = t.y; v[j + 2] = t.z; v[j + 3] = t.w;
    }
  } else {
    int2 t = *reinterpret_cast<const int2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
}

template <int PER>
__device__ __forceinline__ void store_vec(int32_t* p, const int32_t (&v)[PER]) {
  if constexpr (PER % 4 == 0) {
#pragma unroll
    for (int j = 0; j < PER; j += 4)
      *reinterpret_cast<int4*>(p + j) = make_int4(v[j], v[j + 1], v[j + 2],
                                                  v[j + 3]);
  } else {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  }
}

template <int BITS, int STRIDE>
__global__ void pack_kernel(const int32_t* __restrict__ vals, int64_t n_vals,
                            int64_t n_words, bool vec,
                            uint32_t* __restrict__ words) {
  constexpr int PER = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  int64_t step = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
       w < n_words; w += step) {
    int64_t base = word_base<PER, STRIDE>(w);
    int32_t v[PER];
    if (STRIDE == 1 && vec && base + PER <= n_vals) {
      load_vec<PER>(vals + base, v);
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        int64_t i = base + static_cast<int64_t>(k) * STRIDE;
        v[k] = i < n_vals ? vals[i] : 0;
      }
    }
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < PER; ++k)
      acc |= (static_cast<uint32_t>(v[k]) & MASK) << (32 - BITS * (k + 1));
    words[w] = acc;
  }
}

template <int BITS, int STRIDE>
__global__ void unpack_kernel(const uint32_t* __restrict__ words,
                              int64_t n_words, int64_t n_vals, bool vec,
                              int32_t* __restrict__ vals) {
  constexpr int PER = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  int64_t step = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
       w < n_words; w += step) {
    uint32_t x = words[w];
    int32_t v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k)
      v[k] = static_cast<int32_t>((x >> (32 - BITS * (k + 1))) & MASK);
    int64_t base = word_base<PER, STRIDE>(w);
    if (STRIDE == 1 && vec && base + PER <= n_vals) {
      store_vec<PER>(vals + base, v);
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        int64_t i = base + static_cast<int64_t>(k) * STRIDE;
        if (i < n_vals) vals[i] = v[k];
      }
    }
  }
}

// 8- or 16-byte vector accesses need the values' base pointer aligned to
// the access (every word's first value then is too: PER*4 bytes apart)
inline bool aligned(const void* p, int per) {
  uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return per % 4 == 0 ? a % 16 == 0 : a % 8 == 0;
}

template <int BITS>
void launch_pack(const void* vals, int64_t n_vals, int64_t n_words, bool tile,
                 void* words, cudaStream_t s) {
  bool vec = aligned(vals, 32 / BITS);
  auto v = static_cast<const int32_t*>(vals);
  auto w = static_cast<uint32_t*>(words);
  if (tile)
    pack_kernel<BITS, 128><<<grid_for(n_words), THREADS, 0, s>>>(
        v, n_vals, n_words, false, w);
  else
    pack_kernel<BITS, 1><<<grid_for(n_words), THREADS, 0, s>>>(
        v, n_vals, n_words, vec, w);
}

template <int BITS>
void launch_unpack(const void* words, int64_t n_words, int64_t n_vals,
                   bool tile, void* vals, cudaStream_t s) {
  bool vec = aligned(vals, 32 / BITS);
  auto w = static_cast<const uint32_t*>(words);
  auto v = static_cast<int32_t*>(vals);
  if (tile)
    unpack_kernel<BITS, 128><<<grid_for(n_words), THREADS, 0, s>>>(
        w, n_words, n_vals, false, v);
  else
    unpack_kernel<BITS, 1><<<grid_for(n_words), THREADS, 0, s>>>(
        w, n_words, n_vals, vec, v);
}

}  // namespace

// vals: n_vals int32 (values past n_vals read as 0); words: n_words u32.
// tile != 0 selects the (R, per, 128) tile layout, else the consecutive.
extern "C" int ceaz_bitpack_pack(const void* vals, int64_t n_vals,
                                 int64_t n_words, int32_t bits, int32_t tile,
                                 void* words, void* stream) {
  if (n_words <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: launch_pack<2>(vals, n_vals, n_words, tile != 0, words, s); break;
    case 4: launch_pack<4>(vals, n_vals, n_words, tile != 0, words, s); break;
    case 8: launch_pack<8>(vals, n_vals, n_words, tile != 0, words, s); break;
    case 16: launch_pack<16>(vals, n_vals, n_words, tile != 0, words, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// words: n_words u32; vals: the first n_vals values of the unpacked layout.
extern "C" int ceaz_bitpack_unpack(const void* words, int64_t n_words,
                                   int64_t n_vals, int32_t bits, int32_t tile,
                                   void* vals, void* stream) {
  if (n_words <= 0 || n_vals <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: launch_unpack<2>(words, n_words, n_vals, tile != 0, vals, s); break;
    case 4: launch_unpack<4>(words, n_words, n_vals, tile != 0, vals, s); break;
    case 8: launch_unpack<8>(words, n_words, n_vals, tile != 0, vals, s); break;
    case 16:
      launch_unpack<16>(words, n_words, n_vals, tile != 0, vals, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
