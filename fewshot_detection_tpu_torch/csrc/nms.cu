// Batched greedy NMS for Hopper (sm_90a): one thread block per (image, class)
// row, plain C interface, loaded through ctypes (see ops/nms_device.py).
//
// Replaces the TPU kernel fewshot_detection_tpu/ops/nms_device.py:_nms_kernel
// together with the IoU matrix and the per-row vmap around it. That kernel is
// handed a precomputed (N, N) IoU matrix because the TPU's fast memory holds
// it; here the matrix would be R*K*K*4 bytes of device-memory traffic per
// batch, so the IoU of a pair is computed where it is needed, from the row's
// boxes held in shared memory (K*16 bytes), and nothing but the boxes and
// confidences is read and nothing but the keep mask is written.
//
// Bound on this card: the bytes (R*K*21) take well under a microsecond and
// the pairwise IoUs a few microseconds of float32 arithmetic; what the time
// really follows is the chain of dependent steps (candidate i must be settled
// before candidate i+1 is looked at), one block-wide barrier per step. The
// loop therefore stops at the last candidate with a positive confidence and
// skips the pairwise work of a candidate that is already suppressed.
//
// Arithmetic: the decision is `iou > thresh` in float32 and has to fall as in
// the plain PyTorch version (ops/boxes.py:iou_xywh_t) bit for bit. Every
// operation is therefore an explicitly rounded intrinsic in that function's
// order, so the compiler cannot contract a*b - c into a fused multiply-add;
// the build also passes -fmad=false and never --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float iou_xywh(const float4 a, const float4 b) {
  // a, b: (cx, cy, w, h). x/2 is exact, written as a multiply by 0.5f.
  const float ahw = __fmul_rn(a.z, 0.5f), ahh = __fmul_rn(a.w, 0.5f);
  const float bhw = __fmul_rn(b.z, 0.5f), bhh = __fmul_rn(b.w, 0.5f);
  const float uw = __fsub_rn(fmaxf(__fadd_rn(a.x, ahw), __fadd_rn(b.x, bhw)),
                             fminf(__fsub_rn(a.x, ahw), __fsub_rn(b.x, bhw)));
  const float uh = __fsub_rn(fmaxf(__fadd_rn(a.y, ahh), __fadd_rn(b.y, bhh)),
                             fminf(__fsub_rn(a.y, ahh), __fsub_rn(b.y, bhh)));
  const float cw = __fsub_rn(__fadd_rn(a.z, b.z), uw);
  const float ch = __fsub_rn(__fadd_rn(a.w, b.w), uh);
  const float inter = (cw <= 0.0f || ch <= 0.0f) ? 0.0f : __fmul_rn(cw, ch);
  const float uni = __fsub_rn(
      __fadd_rn(__fmul_rn(a.z, a.w), __fmul_rn(b.z, b.w)), inter);
  return uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
}

// boxes (R, K, 4) float32 cxcywh, conf-descending within a row;
// dsel (R, K) float32, 0 for masked-out slots; keep (R, K) one byte each.
__global__ void nms_rows_kernel(const float4* __restrict__ boxes,
                                const float* __restrict__ dsel,
                                uint8_t* __restrict__ keep, int K,
                                float thresh) {
  extern __shared__ float4 smem[];
  float4* sbox = smem;                               // K boxes
  float* sconf = reinterpret_cast<float*>(smem + K); // K confidences
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * K;

  if (tid == 0) s_last = 0;
  __syncthreads();
  int last = 0;
  for (int j = tid; j < K; j += blockDim.x) {
    sbox[j] = boxes[row + j];
    const float c = dsel[row + j];
    sconf[j] = c;
    if (c > 0.0f) last = j + 1;
  }
  if (last > 0) atomicMax(&s_last, last);
  __syncthreads();
  const int n = s_last;  // candidates past n can neither suppress nor be kept

  for (int i = 0; i < n; ++i) {
    // sconf[i] was last written, if at all, in a step before this one, and
    // this step writes only slots j > i: one barrier per step is enough.
    if (sconf[i] > 0.0f) {
      const float4 bi = sbox[i];
      for (int j = i + 1 + tid; j < n; j += blockDim.x) {
        if (iou_xywh(bi, sbox[j]) > thresh) sconf[j] = 0.0f;
      }
    }
    __syncthreads();
  }

  for (int j = tid; j < K; j += blockDim.x) {
    keep[row + j] = sconf[j] > 0.0f ? 1 : 0;
  }
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int fsd_nms_rows(const void* boxes, const void* dsel, void* keep,
                            int R, int K, float thresh, void* stream) {
  if (R <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(K) * (sizeof(float4) + sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nms_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int threads = ((K + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  nms_rows_kernel<<<R, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(dsel),
      static_cast<uint8_t*>(keep), K, thresh);
  return static_cast<int>(cudaGetLastError());
}
