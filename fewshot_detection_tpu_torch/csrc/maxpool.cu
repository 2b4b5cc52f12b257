// 2x2 stride-2 max pooling of NHWC tensors for Hopper (sm_90a): one pass
// forward, one pass backward, no int64 indices and no saved input. Plain C
// interface, loaded through ctypes (see ops/pool2x2.py).
//
// Replaces no TPU kernel: XLA lowered the pool to its own `reduce_window` on
// the TPU. Eager PyTorch ran it as `max_pool_forward_nhwc`, which writes an
// int64 index per output element (four times the output's own bytes), and
// `max_pool_backward_nhwc`, which reads them back and gathers; autograd also
// kept the pool's full-resolution input alive for the backward.
//
// Bound on this card: bytes. With T the input's bytes, the forward reads x (T)
// and writes y (T/4) and, when a backward will follow, a 1-byte window code per
// output element (T/8 in bfloat16); the backward reads dy and the code and
// writes dx (T). A few comparisons a value, far below the card's rate.
//
// Arithmetic: none. A window's value is one of its four inputs, chosen as
// PyTorch's NHWC kernel on the card chooses: starting from -inf, scan in
// row-major window order and take a value when it is greater than the best so
// far or is a NaN, so ties (and +0 against -0) go to the first and NaNs to the
// last. The code is the position taken last in that order (0-3), or NONE when
// no value was taken, in a window that is all -inf: PyTorch's kernel then
// keeps an index that lies in no window and its backward routes that window's
// gradient nowhere, which this backward does too. dx is dy, copied, at the
// coded position and 0 at the other three.
//
// Vector path (C a multiple of V = 16 / itemsize, x and y (dy and dx) 16-byte
// aligned, the code V-byte aligned): a thread owns V adjacent channels of one
// output position, four 16-byte loads of the window forward (its two rows
// each two adjacent loads, so a warp reads whole 32-byte sectors), one
// 16-byte store of y and one V-byte store of the codes; backward one 16-byte
// load of dy, one V-byte load of the codes and four 16-byte stores of dx.
// Each thread takes UNROLL outputs, all its loads issued before the first is
// used. No shared memory, no atomics. With an odd H or W the backward's
// threads of the last output row or column also write the zeros of the input
// row or column that the floor drops, so every element of dx is written once
// and nothing is cleared first. Scalar path (any other C or alignment): the
// same with V = 1. The library chooses on C and the pointers alone and says
// which path it launched.
//
// Every kernel's name holds "pool" and none of the words that a trace reader
// takes for another kind of kernel (convolution, matrix product...).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;  // outputs a thread, their loads all in flight together
constexpr unsigned NONE = 4;  // the code of a window where no value was taken

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// V values of T, as one load or store moves them
template <typename T, int V>
struct alignas(sizeof(T) * V) Lanes {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Lanes<T, V> load(const T* p) {
  Lanes<T, V> r;
  if constexpr (sizeof(T) * V == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(&r, &u, 16);
  } else {
    r.v[0] = p[0];
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Lanes<T, V>& r) {
  *reinterpret_cast<Lanes<T, V>*>(p) = r;
}

// the V codes of one output vector, one byte each, lane k in byte k
template <int V> struct CodeWord;
template <> struct CodeWord<8> { using type = unsigned long long; };
template <> struct CodeWord<4> { using type = unsigned int; };
template <> struct CodeWord<1> { using type = unsigned char; };

template <int V>
__device__ __forceinline__ typename CodeWord<V>::type load_code(const unsigned char* p) {
  using W = typename CodeWord<V>::type;
  if constexpr (V == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    return static_cast<W>(u.x) | (static_cast<W>(u.y) << 32);
  } else {
    return __ldg(reinterpret_cast<const W*>(p));
  }
}

// Where output vector i (of n, C / V a position) reads: the offset of its
// window's first element in x, and whether it lies on the last output row or
// column.
struct Window {
  long long in;  // element offset of the window's top-left vector
  bool last_row, last_col;
};

template <int V>
__device__ __forceinline__ Window window_of(unsigned i, int C, int H, int W, int Ho, int Wo) {
  const unsigned cv = C / V;
  const unsigned pos = i / cv;
  const unsigned c = (i - pos * cv) * V;
  const unsigned wo = pos % Wo;
  const unsigned t = pos / Wo;
  const unsigned ho = t % Ho;
  const unsigned b = t / Ho;
  Window w;
  w.in = ((static_cast<long long>(b) * H + 2 * ho) * W + 2 * wo) * C + c;
  w.last_row = ho == static_cast<unsigned>(Ho - 1);
  w.last_col = wo == static_cast<unsigned>(Wo - 1);
  return w;
}

// ---- forward ----------------------------------------------------------------

// y (n vectors) and, when code is not null, the window codes. x (B, H, W, C).
template <typename T, int V>
__device__ __forceinline__ void forward(const T* __restrict__ x, T* __restrict__ y,
                                        unsigned char* __restrict__ code, unsigned n, int C,
                                        int H, int W, int Ho, int Wo) {
  const unsigned first = blockIdx.x * (THREADS * UNROLL) + threadIdx.x;
  const long long row = static_cast<long long>(W) * C;
  Lanes<T, V> a[UNROLL][4];
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) {
    const unsigned i = first + j * THREADS;
    if (i < n) {
      const T* p = x + window_of<V>(i, C, H, W, Ho, Wo).in;
      a[j][0] = load<T, V>(p);
      a[j][1] = load<T, V>(p + C);
      a[j][2] = load<T, V>(p + row);
      a[j][3] = load<T, V>(p + row + C);
    }
  }
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) {
    const unsigned i = first + j * THREADS;
    if (i >= n) continue;
    Lanes<T, V> out = a[j][0];  // -inf where no value is taken
    typename CodeWord<V>::type word = 0;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float best = __int_as_float(0xff800000);  // -inf
      unsigned which = NONE;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = to_float(a[j][q].v[k]);
        if (v > best || isnan(v)) {
          best = v;
          out.v[k] = a[j][q].v[k];
          which = q;
        }
      }
      word |= static_cast<typename CodeWord<V>::type>(which) << (8 * k);
    }
    store<T, V>(y + static_cast<long long>(i) * V, out);
    if (code != nullptr) {
      *reinterpret_cast<typename CodeWord<V>::type*>(code + static_cast<long long>(i) * V) = word;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
maxpool2x2_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, unsigned char* __restrict__ code,
                      unsigned n, int C, int H, int W, int Ho, int Wo) {
  forward<T, 16 / sizeof(T)>(x, y, code, n, C, H, W, Ho, Wo);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
maxpool2x2_fwd_scalar_kernel(const T* __restrict__ x, T* __restrict__ y,
                             unsigned char* __restrict__ code, unsigned n, int C, int H, int W,
                             int Ho, int Wo) {
  forward<T, 1>(x, y, code, n, C, H, W, Ho, Wo);
}

// ---- backward ---------------------------------------------------------------

// dx (B, H, W, C) from dy (n vectors) and the codes.
template <typename T, int V>
__device__ __forceinline__ void backward(const T* __restrict__ dy,
                                         const unsigned char* __restrict__ code,
                                         T* __restrict__ dx, unsigned n, int C, int H, int W,
                                         int Ho, int Wo) {
  const unsigned first = blockIdx.x * (THREADS * UNROLL) + threadIdx.x;
  const long long row = static_cast<long long>(W) * C;
  const bool odd_h = H > 2 * Ho, odd_w = W > 2 * Wo;
  Lanes<T, V> d[UNROLL];
  typename CodeWord<V>::type word[UNROLL];
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) {
    const unsigned i = first + j * THREADS;
    if (i < n) {
      d[j] = load<T, V>(dy + static_cast<long long>(i) * V);
      word[j] = load_code<V>(code + static_cast<long long>(i) * V);
    }
  }
  Lanes<T, V> zero;
#pragma unroll
  for (int k = 0; k < V; ++k) zero.v[k] = T(0.f);
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) {
    const unsigned i = first + j * THREADS;
    if (i >= n) continue;
    const Window w = window_of<V>(i, C, H, W, Ho, Wo);
    T* p = dx + w.in;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      Lanes<T, V> out;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const unsigned which = static_cast<unsigned>(word[j] >> (8 * k)) & 0xffu;
        out.v[k] = which == static_cast<unsigned>(q) ? d[j].v[k] : T(0.f);
      }
      store<T, V>(p + (q >> 1) * row + (q & 1) * C, out);
    }
    // the input row and column that the floor drops
    if (odd_w && w.last_col) {
      store<T, V>(p + 2 * C, zero);
      store<T, V>(p + row + 2 * C, zero);
    }
    if (odd_h && w.last_row) {
      store<T, V>(p + 2 * row, zero);
      store<T, V>(p + 2 * row + C, zero);
      if (odd_w && w.last_col) store<T, V>(p + 2 * row + 2 * C, zero);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
maxpool2x2_bwd_kernel(const T* __restrict__ dy, const unsigned char* __restrict__ code,
                      T* __restrict__ dx, unsigned n, int C, int H, int W, int Ho, int Wo) {
  backward<T, 16 / sizeof(T)>(dy, code, dx, n, C, H, W, Ho, Wo);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
maxpool2x2_bwd_scalar_kernel(const T* __restrict__ dy, const unsigned char* __restrict__ code,
                             T* __restrict__ dx, unsigned n, int C, int H, int W, int Ho,
                             int Wo) {
  backward<T, 1>(dy, code, dx, n, C, H, W, Ho, Wo);
}

// ---- launches ---------------------------------------------------------------

constexpr int F32 = 0, BF16 = 1, F16 = 2;
// output vectors a launch takes at most, so that a thread's index fits 32 bits
constexpr long long MAX_N = 1ll << 30;

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

int itemsize(int dtype) { return dtype == F32 ? 4 : 2; }

// Launches `launch(first image, images)` over the batch in as few pieces as
// keep each under MAX_N output vectors (one piece at any shape a cell uses).
template <typename L>
int by_images(long long B, long long per_image, L launch) {
  if (per_image > MAX_N) return static_cast<int>(cudaErrorInvalidValue);
  const long long step = MAX_N / per_image;
  for (long long b = 0; b < B; b += step) {
    launch(b, B - b < step ? B - b : step);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

unsigned blocks(long long n) {
  return static_cast<unsigned>((n + THREADS * UNROLL - 1) / (THREADS * UNROLL));
}

template <typename T>
int fwd_typed(bool vector, const void* x, void* y, void* code, long long B, int H, int W, int C,
              cudaStream_t st) {
  const int V = vector ? 16 / sizeof(T) : 1;
  const int Ho = H / 2, Wo = W / 2;
  const long long per_image = static_cast<long long>(Ho) * Wo * (C / V);
  const long long in_image = static_cast<long long>(H) * W * C;
  const long long out_image = static_cast<long long>(Ho) * Wo * C;
  return by_images(B, per_image, [&](long long b, long long nb) {
    const T* xp = static_cast<const T*>(x) + b * in_image;
    T* yp = static_cast<T*>(y) + b * out_image;
    unsigned char* cp = code ? static_cast<unsigned char*>(code) + b * out_image : nullptr;
    const unsigned n = static_cast<unsigned>(nb * per_image);
    if (vector) {
      maxpool2x2_fwd_kernel<T><<<blocks(n), THREADS, 0, st>>>(xp, yp, cp, n, C, H, W, Ho, Wo);
    } else {
      maxpool2x2_fwd_scalar_kernel<T><<<blocks(n), THREADS, 0, st>>>(xp, yp, cp, n, C, H, W, Ho,
                                                                      Wo);
    }
  });
}

template <typename T>
int bwd_typed(bool vector, const void* dy, const void* code, void* dx, long long B, int H, int W,
              int C, cudaStream_t st) {
  const int V = vector ? 16 / sizeof(T) : 1;
  const int Ho = H / 2, Wo = W / 2;
  const long long per_image = static_cast<long long>(Ho) * Wo * (C / V);
  const long long in_image = static_cast<long long>(H) * W * C;
  const long long out_image = static_cast<long long>(Ho) * Wo * C;
  return by_images(B, per_image, [&](long long b, long long nb) {
    const T* dp = static_cast<const T*>(dy) + b * out_image;
    const unsigned char* cp = static_cast<const unsigned char*>(code) + b * out_image;
    T* xp = static_cast<T*>(dx) + b * in_image;
    const unsigned n = static_cast<unsigned>(nb * per_image);
    if (vector) {
      maxpool2x2_bwd_kernel<T><<<blocks(n), THREADS, 0, st>>>(dp, cp, xp, n, C, H, W, Ho, Wo);
    } else {
      maxpool2x2_bwd_scalar_kernel<T><<<blocks(n), THREADS, 0, st>>>(dp, cp, xp, n, C, H, W, Ho,
                                                                      Wo);
    }
  });
}

bool bad_shape(long long B, int H, int W, int C, int dtype) {
  return B <= 0 || H < 2 || W < 2 || C <= 0 || dtype < F32 || dtype > F16;
}

}  // namespace

// x: (B, H, W, C) row-major, float32, bfloat16 or float16 (dtype 0, 1, 2); y:
// (B, H/2, W/2, C) in x's type (floor); code: (B, H/2, W/2, C) bytes, or null
// for no codes. The vector path runs when C is a multiple of 16 / itemsize, x
// and y are 16-byte aligned and code is aligned to that many bytes, else the
// scalar path; *path says which (1 vector, 0 scalar). Kernel launches on
// `stream` (one unless an image's outputs pass 2^30 vectors), no
// synchronisation, no allocation. Returns the cudaError_t of the launches (0
// on success).
extern "C" int fsd_maxpool2x2_fwd(const void* x, void* y, void* code, long long B, int H, int W,
                                  int C, int dtype, void* stream, int* path) {
  if (bad_shape(B, H, W, C, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int V = 16 / itemsize(dtype);
  const bool vector = C % V == 0 && aligned(x, 16) && aligned(y, 16) &&
                      (code == nullptr || aligned(code, V));
  *path = vector ? 1 : 0;
  if (dtype == BF16) return fwd_typed<__nv_bfloat16>(vector, x, y, code, B, H, W, C, st);
  if (dtype == F16) return fwd_typed<__half>(vector, x, y, code, B, H, W, C, st);
  return fwd_typed<float>(vector, x, y, code, B, H, W, C, st);
}

// dy: (B, H/2, W/2, C) row-major in the type of the forward's x; code: the
// forward's codes; dx: (B, H, W, C), every element written. The vector path
// runs when C is a multiple of 16 / itemsize, dy and dx are 16-byte aligned
// and code is aligned to that many bytes, else the scalar path. Same contract
// as the forward otherwise.
extern "C" int fsd_maxpool2x2_bwd(const void* dy, const void* code, void* dx, long long B, int H,
                                  int W, int C, int dtype, void* stream, int* path) {
  if (bad_shape(B, H, W, C, dtype) || code == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int V = 16 / itemsize(dtype);
  const bool vector = C % V == 0 && aligned(dy, 16) && aligned(dx, 16) && aligned(code, V);
  *path = vector ? 1 : 0;
  if (dtype == BF16) return bwd_typed<__nv_bfloat16>(vector, dy, code, dx, B, H, W, C, st);
  if (dtype == F16) return bwd_typed<__half>(vector, dy, code, dx, B, H, W, C, st);
  return bwd_typed<float>(vector, dy, code, dx, B, H, W, C, st);
}
