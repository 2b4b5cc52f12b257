// Training BatchNorm's epilogue for Hopper (sm_90a): the per-channel affine
// pair and the activation, out = act(y * inv + bias), in one pass forward, and
// its backward in one pass that also takes the pair's gradients. Plain C
// interface, loaded through ctypes (see ops/bn_act.py).
//
// Replaces no TPU kernel. XLA fuses this epilogue into its neighbours on the
// TPU; eager PyTorch ran it as five elementwise kernels forward (multiply, add,
// the mask, the scalar multiply, `where`) and about ten backward (two `where`
// backwards, the scalar multiply's, the accumulation, g * inv, the full g * y
// and two reductions), about 60 bytes an element where the function needs 10.
//
// Bound on this card: bytes. The forward reads y and writes out; the backward
// reads dout and y, writes dy and 2*C floats. A few float32 operations a value,
// far below the card's rate.
//
// Arithmetic: every rounding of the composition it replaces, in the same
// place. With r() rounding to y's type (nothing for float32):
//   z = r(r(y * r(inv)) + r(bias))
//   out: leaky z >= 0 ? z : r(z * 0.1f); relu z <= 0 ? 0 : z; linear z
//   g (autograd's gradient at z): leaky z >= 0 ? dout : r(dout * 0.1f);
//     relu z <= 0 ? 0 : dout (threshold_backward); linear dout
//   dy = r(g * r(inv)),  dinv = r(sum r(g * y)),  dbias = r(sum g)
// with float32 sums rounded once. The build passes -fmad=false, so nothing is
// contracted. out and dy are the composition's bits; the two sums differ from
// its reductions only in the order of their additions.
//
// Vector path (C a multiple of V = 16 / itemsize and every array of y's type
// 16-byte aligned), the geometry of csrc/bn_sums.cu's forward: a thread owns V
// adjacent channels, one 16-byte load of each array a row; LANES = 8
// neighbouring threads cover a channel tile (one 128-byte line of a row) and
// the rest of the warp takes further rows; a pass of a block of 8 warps is
// UNROLL loads of each array a thread, all issued before the first is used. A
// thread keeps its channels for all its rows, so r(inv) and r(bias) stay in
// registers. Scalar path (any other C or alignment): one value a thread, 32
// adjacent channels a warp, rows folded when C < 32. The library chooses the
// path on C and the pointers alone and reports which one it launched.
//
// The backward's sums: one launch, no float atomics, as bn_sums' forward. Each
// thread keeps float32 chains of its rows (two a channel on the vector path,
// four on the scalar), the block folds them in a fixed order into its row of
// a (G, 2, C) table of partials in the workspace, fences and draws a ticket
// from its channel tile's counter; the block that draws the tile's last ticket
// folds the G rows in a fixed order, rounds and writes, and puts the counter
// back to 0. Two launches on the same input give the same bits. The workspace
// belongs to one stream: launches on a stream run one after the other.
//
// Every kernel's name holds "elementwise" and none of the words that a trace
// reader takes for another kind of kernel (convolution, reduction, copy...).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;  // lanes of a warp
constexpr int TY = 8;   // warps of a block
constexpr int THREADS = TX * TY;
constexpr int LANES = 8;   // threads across a channel tile of the vector path
constexpr int UNROLL = 4;  // loads of each array a thread has in flight

constexpr int LEAKY = 0, RELU = 1, LINEAR = 2;

template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// z of one value: y * r(inv) + r(bias), each step rounded to y's type
template <typename T>
__device__ __forceinline__ float affine(float v, float a, float b) {
  return rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(v, a)), b));
}

template <typename T, int ACT>
__device__ __forceinline__ float act_fwd(float v, float a, float b) {
  const float z = affine<T>(v, a, b);
  if (ACT == LEAKY) return z >= 0.f ? z : rnd<T>(__fmul_rn(z, 0.1f));
  if (ACT == RELU) return z <= 0.f ? 0.f : z;
  return z;
}

// the gradient at z, given the upstream gradient d
template <typename T, int ACT>
__device__ __forceinline__ float grad_z(float v, float d, float a, float b) {
  if (ACT == LINEAR) return d;
  const float z = affine<T>(v, a, b);
  if (ACT == LEAKY) return z >= 0.f ? d : rnd<T>(__fmul_rn(d, 0.1f));
  return z <= 0.f ? 0.f : d;
}

// ---- 16-byte vectors --------------------------------------------------------

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void unpack(const uint4 u, float (&v)[4]) {
    v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  // a bfloat16 is the upper half of the float32 of the same value; the lower
  // address is the lower half of the 32-bit word
  static __device__ __forceinline__ void unpack(const uint4 u, float (&v)[8]) {
    v[0] = __uint_as_float(u.x << 16); v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16); v[3] = __uint_as_float(u.y & 0xffff0000u);
    v[4] = __uint_as_float(u.z << 16); v[5] = __uint_as_float(u.z & 0xffff0000u);
    v[6] = __uint_as_float(u.w << 16); v[7] = __uint_as_float(u.w & 0xffff0000u);
  }
  // every value packed here is already a bfloat16 (rounded by rnd, a zero or
  // an input), so its float32 has a zero lower half and the cut is exact
  static __device__ __forceinline__ uint32_t two(float lo, float hi) {
    return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[8]) {
    return make_uint4(two(v[0], v[1]), two(v[2], v[3]), two(v[4], v[5]), two(v[6], v[7]));
  }
};

// Vector geometry: which vector column and which rows this thread owns.
struct VecLane {
  int vec;           // vector column (channels vec*V .. vec*V + V - 1)
  bool active;
  long long row;     // first row of the thread within a pass of its block
  long long rows_u;  // rows one load of the block covers
  int cw;            // vectors of a row a warp covers (min(C / V, LANES))
  int fold;          // rows a warp covers
};

__device__ __forceinline__ VecLane vec_lane(int CV) {
  VecLane l;
  l.cw = CV < LANES ? CV : LANES;
  l.fold = TX / l.cw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / l.cw;
  l.vec = blockIdx.x * l.cw + (lane - sub * l.cw);
  l.active = sub < l.fold && l.vec < CV;
  l.row = static_cast<long long>(warp) * l.fold + sub;
  l.rows_u = TY * l.fold;
  return l;
}

// Scalar geometry: which channel and which rows this thread owns.
struct Lane {
  int ch;            // channel, valid when active
  bool active;
  long long row;     // first row
  long long stride;  // rows between two of this thread's rows
  int cw;            // channels a warp covers (min(C, 32))
  int fold;          // rows a warp covers (1 unless C < 32)
};

__device__ __forceinline__ Lane lane_of(int C) {
  Lane l;
  l.cw = C < TX ? C : TX;
  l.fold = C < TX ? TX / C : 1;
  const int tx = threadIdx.x;
  const int sub = tx / l.cw;
  l.ch = blockIdx.x * TX + (tx - sub * l.cw);
  l.active = sub < l.fold && l.ch < C;
  l.stride = static_cast<long long>(gridDim.y) * TY * l.fold;
  l.row = (static_cast<long long>(blockIdx.y) * TY + threadIdx.y) * l.fold + sub;
  return l;
}

template <typename T>
__device__ __forceinline__ void pair_of(const float* inv, const float* bias, int c,
                                        float& a, float& b) {
  a = rnd<T>(__ldg(inv + c));
  b = rnd<T>(__ldg(bias + c));
}

// ---- forward ----------------------------------------------------------------

template <typename T, int ACT>
__device__ __forceinline__ uint4 fwd_vec(const uint4 u, const float (&a)[Vec<T>::V],
                                         const float (&b)[Vec<T>::V]) {
  float v[Vec<T>::V];
  Vec<T>::unpack(u, v);
#pragma unroll
  for (int k = 0; k < Vec<T>::V; ++k) v[k] = act_fwd<T, ACT>(v[k], a[k], b[k]);
  return Vec<T>::pack(v);
}

// y and out as 16-byte vectors, C / V a row. grid (channel tiles, G).
template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS, 4)
bn_act_elementwise_fwd_kernel(const uint4* __restrict__ y, const float* __restrict__ inv,
                              const float* __restrict__ bias, uint4* __restrict__ out,
                              long long M, int C) {
  constexpr int V = Vec<T>::V;
  const int CV = C / V;
  const VecLane l = vec_lane(CV);
  if (!l.active) return;
  float a[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) pair_of<T>(inv, bias, l.vec * V + k, a[k], b[k]);
  const uint4* p = y + l.vec;
  uint4* o = out + l.vec;
  const long long pass = UNROLL * l.rows_u;
  const long long step = static_cast<long long>(gridDim.y) * pass;
  for (long long r0 = blockIdx.y * pass; r0 < M; r0 += step) {
    const long long r = r0 + l.row;
    if (r0 + pass <= M) {
      uint4 u[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) u[j] = __ldg(p + (r + j * l.rows_u) * CV);
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) o[(r + j * l.rows_u) * CV] = fwd_vec<T, ACT>(u[j], a, b);
    } else {  // the ragged end
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        const long long rj = r + j * l.rows_u;
        if (rj < M) o[rj * CV] = fwd_vec<T, ACT>(__ldg(p + rj * CV), a, b);
      }
    }
  }
}

template <typename T, int ACT>
__global__ void bn_act_elementwise_fwd_scalar_kernel(const T* __restrict__ y,
                                                     const float* __restrict__ inv,
                                                     const float* __restrict__ bias,
                                                     T* __restrict__ out, long long M,
                                                     int C) {
  const Lane l = lane_of(C);
  if (!l.active) return;
  float a, b;
  pair_of<T>(inv, bias, l.ch, a, b);
  const T* p = y + l.ch;
  T* o = out + l.ch;
  long long r = l.row;
  for (; r + 3 * l.stride < M; r += 4 * l.stride) {
    const float v0 = load(p + r * C);
    const float v1 = load(p + (r + l.stride) * C);
    const float v2 = load(p + (r + 2 * l.stride) * C);
    const float v3 = load(p + (r + 3 * l.stride) * C);
    store(o + r * C, act_fwd<T, ACT>(v0, a, b));
    store(o + (r + l.stride) * C, act_fwd<T, ACT>(v1, a, b));
    store(o + (r + 2 * l.stride) * C, act_fwd<T, ACT>(v2, a, b));
    store(o + (r + 3 * l.stride) * C, act_fwd<T, ACT>(v3, a, b));
  }
  for (; r < M; r += l.stride) store(o + r * C, act_fwd<T, ACT>(load(p + r * C), a, b));
}

// ---- backward ---------------------------------------------------------------

__device__ __forceinline__ void ldcg(const float* p, float (&v)[1]) {
  v[0] = __ldcg(p);
}
__device__ __forceinline__ void ldcg(const float* p, float (&v)[4]) {
  const float4 f = __ldcg(reinterpret_cast<const float4*>(p));
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}

// Called by every thread of a block once the block's row of the table is
// written: draws the tile's ticket, and in the block that drew the last one
// folds rows 0..G-1 of the tile's 2*nch columns (channels ch0..ch0+nch of
// dinv, then of dbias) into sums, each rounded once to T. W floats a load: 4
// needs C, ch0 and nch to be multiples of 4. sh: THREADS * W floats of shared
// memory that the caller no longer needs. The table is read through L2
// (__ldcg): other blocks wrote it. (csrc/bn_sums.cu's fold, with the rounding.)
template <typename T, int W>
__device__ void finish_tile(float* table, int* ticket, float* sums, int G, int C,
                            int ch0, int nch, float* sh, int tid) {
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(ticket, 1) == G - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int per = nch / W;         // column groups of one of the two sums
  const int ncg = 2 * per;         // <= THREADS / 2
  const int gs = THREADS / ncg;    // threads that share a column group
  const int cg = tid % ncg, gp = tid / ncg;
  const int which = cg / per;
  const int c = ch0 + (cg - which * per) * W;
  float acc[W];
#pragma unroll
  for (int k = 0; k < W; ++k) acc[k] = 0.f;
  if (gp < gs) {
    const float* p = table + static_cast<size_t>(which) * C + c;
#pragma unroll 4
    for (int g = gp; g < G; g += gs) {
      float v[W];
      ldcg(p + static_cast<size_t>(g) * 2 * C, v);
#pragma unroll
      for (int k = 0; k < W; ++k) acc[k] += v[k];
    }
#pragma unroll
    for (int k = 0; k < W; ++k) sh[(gp * ncg + cg) * W + k] = acc[k];
  }
  __syncthreads();
  if (tid < ncg) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      float s = 0.f;
      for (int y = 0; y < gs; ++y) s += sh[(y * ncg + tid) * W + k];
      sums[static_cast<size_t>(which) * C + c + k] = rnd<T>(s);
    }
    if (tid == 0) *ticket = 0;
  }
}

// dy of one vector, and its terms added to the chains sgy (r(g * y)) and sg (g)
template <typename T, int ACT>
__device__ __forceinline__ uint4 bwd_vec(const uint4 ud, const uint4 uy,
                                         const float (&a)[Vec<T>::V],
                                         const float (&b)[Vec<T>::V],
                                         float (&sgy)[Vec<T>::V], float (&sg)[Vec<T>::V]) {
  float d[Vec<T>::V], v[Vec<T>::V];
  Vec<T>::unpack(ud, d);
  Vec<T>::unpack(uy, v);
#pragma unroll
  for (int k = 0; k < Vec<T>::V; ++k) {
    const float g = grad_z<T, ACT>(v[k], d[k], a[k], b[k]);
    sgy[k] += rnd<T>(__fmul_rn(g, v[k]));
    sg[k] += g;
    d[k] = rnd<T>(__fmul_rn(g, a[k]));
  }
  return Vec<T>::pack(d);
}

// dout, y and dy as 16-byte vectors, C / V a row. grid (channel tiles, G).
// table (G, 2, C), sums (2, C): dinv then dbias.
template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS, 2)
bn_act_elementwise_bwd_kernel(const uint4* __restrict__ dout, const uint4* __restrict__ y,
                              const float* __restrict__ inv, const float* __restrict__ bias,
                              uint4* __restrict__ dy, float* table, int* tickets,
                              float* sums, long long M, int C) {
  constexpr int V = Vec<T>::V;
  __shared__ __align__(16) float sh[THREADS * 2 * V];
  const int CV = C / V;
  const VecLane l = vec_lane(CV);
  const int tid = threadIdx.x;
  // two chains a sum (even loads, odd loads), so that chains are short
  float gya[V], gyb[V], ga[V], gb[V];
#pragma unroll
  for (int k = 0; k < V; ++k) gya[k] = gyb[k] = ga[k] = gb[k] = 0.f;
  if (l.active) {
    float a[V], b[V];
#pragma unroll
    for (int k = 0; k < V; ++k) pair_of<T>(inv, bias, l.vec * V + k, a[k], b[k]);
    const uint4* pd = dout + l.vec;
    const uint4* py = y + l.vec;
    uint4* o = dy + l.vec;
    const long long pass = UNROLL * l.rows_u;
    const long long step = static_cast<long long>(gridDim.y) * pass;
    for (long long r0 = blockIdx.y * pass; r0 < M; r0 += step) {
      const long long r = r0 + l.row;
      if (r0 + pass <= M) {
        uint4 ud[UNROLL], uy[UNROLL];
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
          ud[j] = __ldg(pd + (r + j * l.rows_u) * CV);
          uy[j] = __ldg(py + (r + j * l.rows_u) * CV);
        }
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
          o[(r + j * l.rows_u) * CV] = (j & 1)
              ? bwd_vec<T, ACT>(ud[j], uy[j], a, b, gyb, gb)
              : bwd_vec<T, ACT>(ud[j], uy[j], a, b, gya, ga);
        }
      } else {  // the ragged end
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
          const long long rj = r + j * l.rows_u;
          if (rj < M) {
            o[rj * CV] = (j & 1)
                ? bwd_vec<T, ACT>(__ldg(pd + rj * CV), __ldg(py + rj * CV), a, b, gyb, gb)
                : bwd_vec<T, ACT>(__ldg(pd + rj * CV), __ldg(py + rj * CV), a, b, gya, ga);
          }
        }
      }
    }
  }
  float* mine = sh + tid * 2 * V;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mine[k] = gya[k] + gyb[k];
    mine[V + k] = ga[k] + gb[k];
  }
  __syncthreads();
  // the block's partials, folded over warps and folded rows in a fixed order
  const int tile_ch = l.cw * V;
  const int ch0 = blockIdx.x * tile_ch;
  float* row = table + static_cast<size_t>(blockIdx.y) * 2 * C;
  for (int idx = tid; idx < 2 * tile_ch; idx += THREADS) {
    const int which = idx / tile_ch;
    const int c = idx - which * tile_ch;
    if (ch0 + c >= C) continue;
    const int v = c / V, k = c - v * V;
    float s = 0.f;
    for (int w = 0; w < TY; ++w) {
      for (int f = 0; f < l.fold; ++f) {
        s += sh[((w * TX) + f * l.cw + v) * 2 * V + which * V + k];
      }
    }
    row[static_cast<size_t>(which) * C + ch0 + c] = s;
  }
  const int nch = C - ch0 < tile_ch ? C - ch0 : tile_ch;
  finish_tile<T, 4>(table, tickets + blockIdx.x, sums, gridDim.y, C, ch0, nch, sh, tid);
}

template <typename T, int ACT>
__device__ __forceinline__ float bwd_one(const T* pd, const T* py, long long i, float a, float b,
                                         float& sgy, float& sg) {
  const float v = load(py + i);
  const float g = grad_z<T, ACT>(v, load(pd + i), a, b);
  sgy += rnd<T>(__fmul_rn(g, v));
  sg += g;
  return rnd<T>(__fmul_rn(g, a));
}

template <typename T, int ACT>
__global__ void bn_act_elementwise_bwd_scalar_kernel(const T* __restrict__ dout,
                                                     const T* __restrict__ y,
                                                     const float* __restrict__ inv,
                                                     const float* __restrict__ bias,
                                                     T* __restrict__ dy, float* table,
                                                     int* tickets, float* sums, long long M,
                                                     int C) {
  __shared__ float sh_gy[THREADS];
  __shared__ float sh_g[THREADS];
  const Lane l = lane_of(C);
  // four chains a sum: shorter chains round less and keep four rows in flight
  float gy0 = 0.f, gy1 = 0.f, gy2 = 0.f, gy3 = 0.f;
  float g0 = 0.f, g1 = 0.f, g2 = 0.f, g3 = 0.f;
  if (l.active) {
    float a, b;
    pair_of<T>(inv, bias, l.ch, a, b);
    const T* pd = dout + l.ch;
    const T* py = y + l.ch;
    T* o = dy + l.ch;
    long long r = l.row;
    for (; r + 3 * l.stride < M; r += 4 * l.stride) {
      const long long i0 = r * C, i1 = (r + l.stride) * C;
      const long long i2 = (r + 2 * l.stride) * C, i3 = (r + 3 * l.stride) * C;
      const float d0 = bwd_one<T, ACT>(pd, py, i0, a, b, gy0, g0);
      const float d1 = bwd_one<T, ACT>(pd, py, i1, a, b, gy1, g1);
      const float d2 = bwd_one<T, ACT>(pd, py, i2, a, b, gy2, g2);
      const float d3 = bwd_one<T, ACT>(pd, py, i3, a, b, gy3, g3);
      store(o + i0, d0);
      store(o + i1, d1);
      store(o + i2, d2);
      store(o + i3, d3);
    }
    // the last rows go on round the four chains, so no chain takes more
    // than a quarter of the thread's rows, rounded up
    if (r < M) {
      store(o + r * C, bwd_one<T, ACT>(pd, py, r * C, a, b, gy0, g0));
      r += l.stride;
    }
    if (r < M) {
      store(o + r * C, bwd_one<T, ACT>(pd, py, r * C, a, b, gy1, g1));
      r += l.stride;
    }
    if (r < M) store(o + r * C, bwd_one<T, ACT>(pd, py, r * C, a, b, gy2, g2));
  }
  const int tid = threadIdx.y * TX + threadIdx.x;
  sh_gy[tid] = (gy0 + gy1) + (gy2 + gy3);
  sh_g[tid] = (g0 + g1) + (g2 + g3);
  __syncthreads();
  // the first cw lanes of warp 0 fold the block's partials in a fixed order
  const int tx = threadIdx.x;
  const int ch0 = blockIdx.x * TX;
  if (threadIdx.y == 0 && tx < l.cw && ch0 + tx < C) {
    float sgy = 0.f, sg = 0.f;
    for (int w = 0; w < TY; ++w) {
      for (int f = 0; f < l.fold; ++f) {
        sgy += sh_gy[w * TX + f * l.cw + tx];
        sg += sh_g[w * TX + f * l.cw + tx];
      }
    }
    float* row = table + static_cast<size_t>(blockIdx.y) * 2 * C;
    row[ch0 + tx] = sgy;
    row[C + ch0 + tx] = sg;
  }
  const int nch = C - ch0 < TX ? C - ch0 : TX;
  finish_tile<T, 1>(table, tickets + blockIdx.x, sums, gridDim.y, C, ch0, nch, sh_gy, tid);
}

bool bad_shape(long long M, int C, int G, int act) {
  return M <= 0 || C <= 0 || G <= 0 || G > 65535 || act < LEAKY || act > LINEAR;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int ACT>
void launch_fwd(bool vector, const void* y, const float* inv, const float* bias, void* out,
                long long M, int C, int G, cudaStream_t st) {
  if (vector) {
    constexpr int V = Vec<T>::V;
    const int CV = C / V;
    const int cw = CV < LANES ? CV : LANES;
    bn_act_elementwise_fwd_kernel<T, ACT><<<dim3((CV + cw - 1) / cw, G), THREADS, 0, st>>>(
        static_cast<const uint4*>(y), inv, bias, static_cast<uint4*>(out), M, C);
  } else {
    bn_act_elementwise_fwd_scalar_kernel<T, ACT>
        <<<dim3((C + TX - 1) / TX, G), dim3(TX, TY), 0, st>>>(
            static_cast<const T*>(y), inv, bias, static_cast<T*>(out), M, C);
  }
}

template <typename T, int ACT>
void launch_bwd(bool vector, const void* dout, const void* y, const float* inv,
                const float* bias, void* dy, float* table, int* tickets, float* sums,
                long long M, int C, int G, cudaStream_t st) {
  if (vector) {
    constexpr int V = Vec<T>::V;
    const int CV = C / V;
    const int cw = CV < LANES ? CV : LANES;
    bn_act_elementwise_bwd_kernel<T, ACT><<<dim3((CV + cw - 1) / cw, G), THREADS, 0, st>>>(
        static_cast<const uint4*>(dout), static_cast<const uint4*>(y), inv, bias,
        static_cast<uint4*>(dy), table, tickets, sums, M, C);
  } else {
    bn_act_elementwise_bwd_scalar_kernel<T, ACT>
        <<<dim3((C + TX - 1) / TX, G), dim3(TX, TY), 0, st>>>(
            static_cast<const T*>(dout), static_cast<const T*>(y), inv, bias,
            static_cast<T*>(dy), table, tickets, sums, M, C);
  }
}

template <typename T>
void dispatch_fwd(int act, bool vector, const void* y, const float* inv, const float* bias,
                  void* out, long long M, int C, int G, cudaStream_t st) {
  if (act == LEAKY) launch_fwd<T, LEAKY>(vector, y, inv, bias, out, M, C, G, st);
  else if (act == RELU) launch_fwd<T, RELU>(vector, y, inv, bias, out, M, C, G, st);
  else launch_fwd<T, LINEAR>(vector, y, inv, bias, out, M, C, G, st);
}

template <typename T>
void dispatch_bwd(int act, bool vector, const void* dout, const void* y, const float* inv,
                  const float* bias, void* dy, float* table, int* tickets, float* sums,
                  long long M, int C, int G, cudaStream_t st) {
  if (act == LEAKY) {
    launch_bwd<T, LEAKY>(vector, dout, y, inv, bias, dy, table, tickets, sums, M, C, G, st);
  } else if (act == RELU) {
    launch_bwd<T, RELU>(vector, dout, y, inv, bias, dy, table, tickets, sums, M, C, G, st);
  } else {
    launch_bwd<T, LINEAR>(vector, dout, y, inv, bias, dy, table, tickets, sums, M, C, G, st);
  }
}

}  // namespace

// y, out: (M, C) row-major, float32 or bfloat16 (is_bf16). inv, bias: C
// floats. act: 0 leaky (slope 0.1), 1 relu, 2 linear. G: blocks along the
// rows. The vector path runs when C is a multiple of 16 / itemsize and y and
// out are 16-byte aligned, else the scalar path; *path says which (1 vector,
// 0 scalar). One kernel launch on `stream`, no synchronisation, no
// allocation. Returns the cudaError_t of the launch (0 on success).
extern "C" int fsd_bn_act_fwd(const void* y, const void* inv, const void* bias, void* out,
                              long long M, int C, int G, int is_bf16, int act, void* stream,
                              int* path) {
  if (bad_shape(M, C, G, act)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int V = is_bf16 ? 8 : 4;
  const bool vector = C % V == 0 && aligned16(y) && aligned16(out);
  *path = vector ? 1 : 0;
  const float* fi = static_cast<const float*>(inv);
  const float* fb = static_cast<const float*>(bias);
  if (is_bf16) {
    dispatch_fwd<__nv_bfloat16>(act, vector, y, fi, fb, out, M, C, G, st);
  } else {
    dispatch_fwd<float>(act, vector, y, fi, fb, out, M, C, G, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// dout, y, dy: (M, C) row-major in y's type. sums: 2*C floats, dinv then
// dbias, each rounded to y's type. workspace: one stream's scratch, 16-byte
// aligned: ticket_slots ints that are 0 before the first launch (the kernel
// leaves them 0), then 2*G*C floats for the table of partials; ticket_slots is
// a multiple of 4 and at least the number of channel tiles, at most
// ceil(C / 32) on either path. The vector path runs when C is a multiple of
// 16 / itemsize and dout, y and dy are 16-byte aligned, else the scalar path;
// *path says which. Same contract as the forward otherwise.
extern "C" int fsd_bn_act_bwd(const void* dout, const void* y, const void* inv,
                              const void* bias, void* dy, void* workspace, int ticket_slots,
                              void* sums, long long M, int C, int G, int is_bf16, int act,
                              void* stream, int* path) {
  if (bad_shape(M, C, G, act) || ticket_slots % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* tickets = static_cast<int*>(workspace);
  float* table = reinterpret_cast<float*>(tickets + ticket_slots);
  const int V = is_bf16 ? 8 : 4;
  const bool vector = C % V == 0 && aligned16(dout) && aligned16(y) && aligned16(dy);
  *path = vector ? 1 : 0;
  const int CV = C / V;
  const int cw = CV < LANES ? CV : LANES;
  const int tiles = vector ? (CV + cw - 1) / cw : (C + TX - 1) / TX;
  if (ticket_slots < tiles) return static_cast<int>(cudaErrorInvalidValue);
  const float* fi = static_cast<const float*>(inv);
  const float* fb = static_cast<const float*>(bias);
  float* s = static_cast<float*>(sums);
  if (is_bf16) {
    dispatch_bwd<__nv_bfloat16>(act, vector, dout, y, fi, fb, dy, table, tickets, s, M, C, G,
                                st);
  } else {
    dispatch_bwd<float>(act, vector, dout, y, fi, fb, dy, table, tickets, s, M, C, G, st);
  }
  return static_cast<int>(cudaGetLastError());
}
