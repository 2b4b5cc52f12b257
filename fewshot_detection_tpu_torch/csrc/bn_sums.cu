// BatchNorm statistics for Hopper (sm_90a): per-channel float32 sum and sum of
// squares of an (M, C) row-major activation, and the backward of that pair.
// Plain C interface, loaded through ctypes (see ops/bn_sums.py).
//
// Replaces the TPU kernel fewshot_detection_tpu/ops/bn_pallas.py:_sums_kernel
// (launched by _sums_pallas_2d) and the elementwise backward of its custom VJP
// (_bn_sums_bwd). The TPU kernel walks its row blocks in order on one core and
// carries the running sums in scratch memory from one grid step to the next;
// here blocks run side by side in no order and nothing carries over, so the
// forward is two kernels: every block sums its own rows into one row of a
// (G, C) table of partials, and a second small kernel folds that table. Both
// add in a fixed order (no float atomics), so two launches on the same input
// give the same bits.
//
// Bound on this card: bytes. The forward reads M*C values once and writes 2*C
// floats; the backward reads M*C values and writes M*C. There is one multiply
// and two adds per value, far below the card's float32 rate.
//
// Geometry, shared by both directions: a block is 32 x 8 threads. The 32 lanes
// of a warp take 32 adjacent channels of one row, so a warp reads one
// contiguous run of memory; when C < 32 the warp takes floor(32 / C) whole
// rows instead (lane l -> row l / C, channel l % C) and the lanes that hold
// the same channel are folded through shared memory. The 8 warps, and the G
// blocks along grid.y, stride over the rows. M and C need not divide anything.
//
// Arithmetic: float32 accumulation whatever the input type. The backward is
// dx = dsum + (2*x)*dsq with each step rounded to float32 and the result
// rounded once to x's type, as the plain PyTorch version does it; the build
// passes -fmad=false so nothing is contracted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;  // lanes: adjacent channels (or folded rows when C < 32)
constexpr int TY = 8;   // warps: row lanes

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Which channel and which rows this thread owns.
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

// psum, psq: (G, C) partial sums, one row per blockIdx.y.
template <typename T>
__global__ void bn_sums_partial_kernel(const T* __restrict__ x,
                                       float* __restrict__ psum,
                                       float* __restrict__ psq, long long M,
                                       int C) {
  __shared__ float sh_s[TY * TX];
  __shared__ float sh_q[TY * TX];
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
      s0 += v0; q0 += v0 * v0;
      s1 += v1; q1 += v1 * v1;
      s2 += v2; q2 += v2 * v2;
      s3 += v3; q3 += v3 * v3;
    }
    for (; r < M; r += l.stride) {
      const float v = load(p + r * C);
      s0 += v; q0 += v * v;
    }
  }
  const int slot = threadIdx.y * TX + threadIdx.x;
  sh_s[slot] = (s0 + s1) + (s2 + s3);
  sh_q[slot] = (q0 + q1) + (q2 + q3);
  __syncthreads();
  // the first cw lanes of warp 0 fold the block's partials in a fixed order
  const int tx = threadIdx.x;
  const int ch = blockIdx.x * TX + tx;
  if (threadIdx.y == 0 && tx < l.cw && ch < C) {
    float s = 0.f, q = 0.f;
    for (int y = 0; y < TY; ++y) {
      for (int f = 0; f < l.fold; ++f) {
        s += sh_s[y * TX + f * l.cw + tx];
        q += sh_q[y * TX + f * l.cw + tx];
      }
    }
    psum[static_cast<size_t>(blockIdx.y) * C + ch] = s;
    psq[static_cast<size_t>(blockIdx.y) * C + ch] = q;
  }
}

// Folds the (G, C) partials into sum[C], sq[C]; one block per 32 channels.
__global__ void bn_sums_fold_kernel(const float* __restrict__ psum,
                                    const float* __restrict__ psq,
                                    float* __restrict__ sum,
                                    float* __restrict__ sq, int G, int C) {
  __shared__ float sh_s[TY * TX];
  __shared__ float sh_q[TY * TX];
  const int tx = threadIdx.x;
  const int ch = blockIdx.x * TX + tx;
  float s = 0.f, q = 0.f;
  if (ch < C) {
    for (int g = threadIdx.y; g < G; g += TY) {
      s += psum[static_cast<size_t>(g) * C + ch];
      q += psq[static_cast<size_t>(g) * C + ch];
    }
  }
  sh_s[threadIdx.y * TX + tx] = s;
  sh_q[threadIdx.y * TX + tx] = q;
  __syncthreads();
  if (threadIdx.y == 0 && ch < C) {
    float ts = 0.f, tq = 0.f;
    for (int y = 0; y < TY; ++y) {
      ts += sh_s[y * TX + tx];
      tq += sh_q[y * TX + tx];
    }
    sum[ch] = ts;
    sq[ch] = tq;
  }
}

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

// x: (M, C) row-major, float32 or bfloat16. partials: 2*G*C floats of scratch.
// out: 2*C floats, the sums then the sums of squares. Launches on `stream`,
// does not synchronise, allocates nothing. Returns the cudaError_t of the
// launches (0 on success).
extern "C" int fsd_bn_sums_fwd(const void* x, void* partials, void* out,
                               long long M, int C, int G, int is_bf16,
                               void* stream) {
  if (bad_shape(M, C, G)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (C + TX - 1) / TX;
  const dim3 block(TX, TY);
  float* psum = static_cast<float*>(partials);
  float* psq = psum + static_cast<size_t>(G) * C;
  if (is_bf16) {
    bn_sums_partial_kernel<__nv_bfloat16><<<dim3(tiles, G), block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), psum, psq, M, C);
  } else {
    bn_sums_partial_kernel<float><<<dim3(tiles, G), block, 0, st>>>(
        static_cast<const float*>(x), psum, psq, M, C);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  float* sum = static_cast<float*>(out);
  bn_sums_fold_kernel<<<tiles, block, 0, st>>>(psum, psq, sum, sum + C, G, C);
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
