// BatchNorm statistics for Hopper (sm_90a): per-channel float32 sum and sum of
// squares of an (M, C) row-major activation, and the backward of that pair.
// Plain C interface, loaded through ctypes (see ops/bn_sums.py).
//
// Replaces the TPU kernel fewshot_detection_tpu/ops/bn_pallas.py:_sums_kernel
// (launched by _sums_pallas_2d) and the elementwise backward of its custom VJP
// (_bn_sums_bwd). The TPU kernel walks its row blocks in order on one core and
// carries the running sums in scratch memory from one grid step to the next;
// here blocks run side by side in no order and nothing carries over.
//
// Bound on this card: bytes. The forward reads M*C values once and writes 2*C
// floats; the backward reads M*C values and writes M*C. There are a handful
// of operations per value, far below the card's float32 rate. What the forward
// has to do is (1) ask for memory in the card's favourite unit, 16 bytes a
// thread on neighbouring addresses, with several such loads in flight, and
// (2) cost one launch, because 20 of a training step's 29 layers are so small
// that launches and allocations outweigh their bytes.
//
// Forward, vector path (C a multiple of V = 16 / itemsize, base 16-byte
// aligned): a thread owns V adjacent channels (4 float32 or 8 bfloat16 values
// in one 16-byte load). LANES = 8 neighbouring threads cover 8*V adjacent
// channels of a row (one 128-byte line), a channel tile, and the 4 groups of
// a warp take as many consecutive rows; when C / V < 8 a warp takes
// floor(32 / (C/V)) whole rows, one contiguous run of memory. Wider tiles
// read no faster and make the table that a tile's last block folds larger.
// A block is 8 warps; one pass of a block is four loads a thread over
// 4 * 8 * fold consecutive rows, all started before the first is used. Sums
// stay float32, in two chains a channel (loads 0, 2 and loads 1, 3) so that
// chains are short.
//
// Forward, scalar path (any other C or alignment): one value a thread, 32
// adjacent channels a warp (or folded rows when C < 32), as the backward.
// fsd_bn_sums_fwd chooses between the two on C and the pointer alone and
// reports which one it launched.
//
// One launch, no float atomics: every block adds its rows into one row of a
// (G, 2, C) table of partials in the workspace, fences, and draws a ticket
// from its channel tile's integer counter; the block that draws the tile's
// last ticket folds the G rows in a fixed order, writes the result and puts
// the counter back to 0. Every addition has a fixed place, so two launches on
// the same input give the same bits. The workspace belongs to one stream:
// launches on a stream run one after the other, so the next launch's blocks
// write the table only after this launch's fold has read it.
//
// Arithmetic: float32 accumulation whatever the input type. The forward's
// square-and-add is one explicitly fused __fmaf_rn (one rounding instead of
// two). The backward is dx = dsum + (2*x)*dsq with each step rounded to
// float32 and the result rounded once to x's type, as the plain PyTorch
// version does it; the build passes -fmad=false so nothing else is contracted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;  // lanes of a warp
constexpr int TY = 8;   // warps of a block
constexpr int THREADS = TX * TY;
constexpr int LANES = 8;  // threads across a channel tile of the vector path

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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
// the sums, then of the squares) into out. W floats a load: 4 needs C, ch0
// and nch to be multiples of 4. sh: THREADS * W floats of shared memory that
// the caller no longer needs. table is read through L2 (__ldcg): other
// blocks wrote it.
template <int W>
__device__ void finish_tile(float* table, int* ticket, float* out, int G, int C,
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
      out[static_cast<size_t>(which) * C + c + k] = s;
    }
    if (tid == 0) *ticket = 0;
  }
}

// ---- forward, vector path -------------------------------------------------

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void unpack(const uint4 u, float (&v)[4]) {
    v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
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
};

template <typename T>
__device__ __forceinline__ void add_vec(const uint4 u, float (&s)[Vec<T>::V],
                                        float (&q)[Vec<T>::V]) {
  float v[Vec<T>::V];
  Vec<T>::unpack(u, v);
#pragma unroll
  for (int k = 0; k < Vec<T>::V; ++k) {
    s[k] += v[k];
    q[k] = __fmaf_rn(v[k], v[k], q[k]);
  }
}

// x as 16-byte vectors, C / V a row. grid (channel tiles, G). table (G, 2, C).
template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
bn_sums_vec_kernel(const uint4* __restrict__ x, float* table, int* tickets,
                   float* out, long long M, int C) {
  constexpr int V = Vec<T>::V;
  __shared__ __align__(16) float sh[THREADS * 2 * V];
  const int CV = C / V;
  const int cw = CV < LANES ? CV : LANES;  // vectors of a row a warp covers
  const int fold = TX / cw;                // rows a warp covers
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / cw;
  const int vec = blockIdx.x * cw + (lane - sub * cw);
  const bool active = sub < fold && vec < CV;
  const long long rows_u = TY * fold;  // rows one load of the block covers
  const long long pass = 4 * rows_u;

  float sa[V], qa[V], sb[V], qb[V];
#pragma unroll
  for (int k = 0; k < V; ++k) sa[k] = qa[k] = sb[k] = qb[k] = 0.f;
  if (active) {
    const uint4* p = x + vec;
    const long long r_in = static_cast<long long>(warp) * fold + sub;
    const long long step = static_cast<long long>(gridDim.y) * pass;
    for (long long r0 = blockIdx.y * pass; r0 < M; r0 += step) {
      const long long r = r0 + r_in;
      uint4 u0, u1, u2, u3;
      if (r0 + pass <= M) {
        u0 = __ldg(p + r * CV);
        u1 = __ldg(p + (r + rows_u) * CV);
        u2 = __ldg(p + (r + 2 * rows_u) * CV);
        u3 = __ldg(p + (r + 3 * rows_u) * CV);
      } else {  // the ragged end: rows past M count as zeros
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        u0 = r < M ? __ldg(p + r * CV) : zero;
        u1 = r + rows_u < M ? __ldg(p + (r + rows_u) * CV) : zero;
        u2 = r + 2 * rows_u < M ? __ldg(p + (r + 2 * rows_u) * CV) : zero;
        u3 = r + 3 * rows_u < M ? __ldg(p + (r + 3 * rows_u) * CV) : zero;
      }
      add_vec<T>(u0, sa, qa);
      add_vec<T>(u1, sb, qb);
      add_vec<T>(u2, sa, qa);
      add_vec<T>(u3, sb, qb);
    }
  }
  float* mine = sh + tid * 2 * V;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mine[k] = sa[k] + sb[k];
    mine[V + k] = qa[k] + qb[k];
  }
  __syncthreads();
  // the block's partials, folded over warps and folded rows in a fixed order
  const int tile_ch = cw * V;
  const int ch0 = blockIdx.x * tile_ch;
  float* row = table + static_cast<size_t>(blockIdx.y) * 2 * C;
  for (int idx = tid; idx < 2 * tile_ch; idx += THREADS) {
    const int which = idx / tile_ch;
    const int c = idx - which * tile_ch;
    if (ch0 + c >= C) continue;
    const int v = c / V, k = c - v * V;
    float s = 0.f;
    for (int w = 0; w < TY; ++w) {
      for (int f = 0; f < fold; ++f) {
        s += sh[((w * TX) + f * cw + v) * 2 * V + which * V + k];
      }
    }
    row[static_cast<size_t>(which) * C + ch0 + c] = s;
  }
  const int nch = C - ch0 < tile_ch ? C - ch0 : tile_ch;
  finish_tile<4>(table, tickets + blockIdx.x, out, gridDim.y, C, ch0, nch, sh, tid);
}

// ---- forward, scalar path -------------------------------------------------

template <typename T>
__global__ void bn_sums_scalar_kernel(const T* __restrict__ x, float* table,
                                      int* tickets, float* out, long long M,
                                      int C) {
  __shared__ float sh_s[THREADS];
  __shared__ float sh_q[THREADS];
  const Lane l = lane_of(C);
  // four independent chains per thread: shorter chains round less and keep
  // four loads in flight
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  float q0 = 0.f, q1 = 0.f, q2 = 0.f, q3 = 0.f;
  if (l.active) {
    const T* p = x + l.ch;
    long long r = l.row;
    for (; r + 3 * l.stride < M; r += 4 * l.stride) {
      const float v0 = load(p + r * C);
      const float v1 = load(p + (r + l.stride) * C);
      const float v2 = load(p + (r + 2 * l.stride) * C);
      const float v3 = load(p + (r + 3 * l.stride) * C);
      s0 += v0; q0 = __fmaf_rn(v0, v0, q0);
      s1 += v1; q1 = __fmaf_rn(v1, v1, q1);
      s2 += v2; q2 = __fmaf_rn(v2, v2, q2);
      s3 += v3; q3 = __fmaf_rn(v3, v3, q3);
    }
    for (; r < M; r += l.stride) {
      const float v = load(p + r * C);
      s0 += v; q0 = __fmaf_rn(v, v, q0);
    }
  }
  const int tid = threadIdx.y * TX + threadIdx.x;
  sh_s[tid] = (s0 + s1) + (s2 + s3);
  sh_q[tid] = (q0 + q1) + (q2 + q3);
  __syncthreads();
  // the first cw lanes of warp 0 fold the block's partials in a fixed order
  const int tx = threadIdx.x;
  const int ch0 = blockIdx.x * TX;
  if (threadIdx.y == 0 && tx < l.cw && ch0 + tx < C) {
    float s = 0.f, q = 0.f;
    for (int y = 0; y < TY; ++y) {
      for (int f = 0; f < l.fold; ++f) {
        s += sh_s[y * TX + f * l.cw + tx];
        q += sh_q[y * TX + f * l.cw + tx];
      }
    }
    float* row = table + static_cast<size_t>(blockIdx.y) * 2 * C;
    row[ch0 + tx] = s;
    row[C + ch0 + tx] = q;
  }
  const int nch = C - ch0 < TX ? C - ch0 : TX;
  finish_tile<1>(table, tickets + blockIdx.x, out, gridDim.y, C, ch0, nch, sh_s, tid);
}

// ---- backward -------------------------------------------------------------

__device__ __forceinline__ float dx_of(float x, float dsum, float dsq) {
  return __fadd_rn(dsum, __fmul_rn(__fmul_rn(2.0f, x), dsq));
}

template <typename T>
__global__ void bn_sums_bwd_kernel(const T* __restrict__ x,
                                   const float* __restrict__ dsum,
                                   const float* __restrict__ dsq,
                                   T* __restrict__ dx, long long M, int C) {
  const Lane l = lane_of(C);
  if (!l.active) return;
  const float a = dsum[l.ch];
  const float b = dsq[l.ch];
  const T* p = x + l.ch;
  T* o = dx + l.ch;
  long long r = l.row;
  for (; r + 3 * l.stride < M; r += 4 * l.stride) {
    const float v0 = load(p + r * C);
    const float v1 = load(p + (r + l.stride) * C);
    const float v2 = load(p + (r + 2 * l.stride) * C);
    const float v3 = load(p + (r + 3 * l.stride) * C);
    store(o + r * C, dx_of(v0, a, b));
    store(o + (r + l.stride) * C, dx_of(v1, a, b));
    store(o + (r + 2 * l.stride) * C, dx_of(v2, a, b));
    store(o + (r + 3 * l.stride) * C, dx_of(v3, a, b));
  }
  for (; r < M; r += l.stride) {
    store(o + r * C, dx_of(load(p + r * C), a, b));
  }
}

bool bad_shape(long long M, int C, int G) {
  return M <= 0 || C <= 0 || G <= 0 || G > 65535;
}

}  // namespace

// x: (M, C) row-major, float32 or bfloat16. out: 2*C floats, the sums then
// the sums of squares. workspace: one stream's scratch, 16-byte aligned:
// ticket_slots ints that are 0 before the first launch (the kernel leaves
// them 0), then 2*G*C floats for the table of partials; ticket_slots is a
// multiple of 4 and at least the number of channel tiles, which is at most
// ceil(C / 32) on either path. G: blocks along the rows. The vector path
// runs when C is a multiple of 16 / itemsize and x is 16-byte aligned, else
// the scalar path; *path says which (1 vector, 0 scalar). One kernel launch
// on `stream`, no synchronisation, no allocation. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int fsd_bn_sums_fwd(const void* x, void* workspace, int ticket_slots,
                               void* out, long long M, int C, int G,
                               int is_bf16, void* stream, int* path) {
  if (bad_shape(M, C, G) || ticket_slots % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* tickets = static_cast<int*>(workspace);
  float* table = reinterpret_cast<float*>(tickets + ticket_slots);
  float* o = static_cast<float*>(out);
  const int V = is_bf16 ? 8 : 4;
  const bool vector = C % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  *path = vector ? 1 : 0;
  const int CV = C / V;
  const int cw = CV < LANES ? CV : LANES;
  const int tiles = vector ? (CV + cw - 1) / cw : (C + TX - 1) / TX;
  if (ticket_slots < tiles) return static_cast<int>(cudaErrorInvalidValue);
  if (vector) {
    const dim3 grid(tiles, G);
    const uint4* xv = static_cast<const uint4*>(x);
    if (is_bf16) {
      bn_sums_vec_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
          xv, table, tickets, o, M, C);
    } else {
      bn_sums_vec_kernel<float><<<grid, THREADS, 0, st>>>(
          xv, table, tickets, o, M, C);
    }
  } else {
    const dim3 grid(tiles, G);
    const dim3 block(TX, TY);
    if (is_bf16) {
      bn_sums_scalar_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), table, tickets, o, M, C);
    } else {
      bn_sums_scalar_kernel<float><<<grid, block, 0, st>>>(
          static_cast<const float*>(x), table, tickets, o, M, C);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// dx[m, c] = dsum[c] + 2 * x[m, c] * dsq[c], in x's type. Same contract.
extern "C" int fsd_bn_sums_bwd(const void* x, const void* dsum, const void* dsq,
                               void* dx, long long M, int C, int G, int is_bf16,
                               void* stream) {
  if (bad_shape(M, C, G)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (C + TX - 1) / TX;
  const dim3 block(TX, TY);
  if (is_bf16) {
    bn_sums_bwd_kernel<__nv_bfloat16><<<dim3(tiles, G), block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dsum),
        static_cast<const float*>(dsq), static_cast<__nv_bfloat16*>(dx), M, C);
  } else {
    bn_sums_bwd_kernel<float><<<dim3(tiles, G), block, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dsum),
        static_cast<const float*>(dsq), static_cast<float*>(dx), M, C);
  }
  return static_cast<int>(cudaGetLastError());
}
