// Batched greedy NMS for Hopper (sm_90a): one thread block per (image, class)
// row, plain C interface, loaded through ctypes (see ops/nms_device.py).
//
// Replaces the TPU kernel fewshot_detection_tpu/ops/nms_device.py:_nms_kernel
// together with the IoU matrix and the per-row vmap around it. That kernel is
// handed a precomputed (N, N) IoU matrix because the TPU's fast memory holds
// it; here the matrix would be R*K*K*4 bytes of device-memory traffic per
// batch, so the IoU of a pair is computed where it is needed, from the row's
// boxes held in shared memory, and nothing but the boxes and confidences is
// read and nothing but the keep mask is written.
//
// Bound on this card: the bytes (R*K*21) take well under a microsecond and
// the pairwise IoUs a few microseconds of float32 arithmetic. Greedy NMS is a
// chain (candidate i must be settled before a later one can be), and a row
// lives in one block on one SM, so what the time follows is the number of
// operations ONE WARP has to get through between two barriers, at the 4 to
// 8 cycles a dependent operation takes: a kernel that settles one
// candidate per block-wide barrier, with the IoU's division inside the step,
// pays that chain once per candidate. This design settles 32 candidates per
// two barriers, keeps the arithmetic out of warp 0's way, and keeps the
// bookkeeping between barriers as short as it can (a thread's candidates and
// its share of a group's members are fixed for the whole kernel: variants
// that re-dealt the live candidates to the threads in every group computed
// fewer IoUs and were slower, for the operations the dealing took):
//
//   (t) before the chain, for every group of 32 candidates in rank order at
//       once: member j gets a 32-bit word whose bit i says "member i of the
//       same group, ranked before j, overlaps j above the threshold" (the
//       group's 32 x 32 triangle). S = 1 << LS neighbouring threads share
//       one j and split the members by bit position, then OR their parts
//       with shuffles (S is 2 while that keeps a block within 512 threads,
//       so that every row of a batch is resident at once, else 1). A
//       triangle does not depend on which members are still live when their
//       group's turn comes, so none of it waits for the chain.
//   then for each group in order (a group with no live member is skipped)
//   (b) warp 0, lane = member, settles the triangle in registers with
//       ballots, looking at live members only. A member is dropped once a
//       kept earlier member overlaps it and kept once no undecided earlier
//       member overlaps it; the lowest undecided member always settles, so
//       the rounds end, usually after two or three. The result is the
//       group's kept bits.
//   (c) every live candidate behind the group is compared with the KEPT
//       members only (a dropped member suppresses nothing, so its IoUs with
//       later groups are never computed) and is dropped at the first that
//       overlaps it; the S threads of a candidate split the kept members as
//       in (t).
//
// Steps (t) and (c) are all the float arithmetic. The loop ends at the last
// candidate with a positive confidence.
//
// Long rows. A row's per-candidate arrays (edges, sizes, confidence and
// triangle word, 40 bytes a candidate) fit one block's shared memory up to
// 5,600 candidates (ops/nms_device.py:MAX_K). A longer row, as a WIDER image
// of up to 1024 x 2560 pixels gives (5 anchors on a stride-32 grid: 12,800
// candidates), keeps the same arrays in a global workspace that the caller
// hands in, one slice a row, and runs the same kernel on them: the same
// steps, the same arithmetic, so the keep mask is the same bit for bit. A
// row of 12,800 candidates is 0.5 MB of workspace, which stays in L2. Only
// the block's own threads touch its slice, and every __syncthreads() makes
// their writes to it visible to each other, as for shared memory. The
// workspace is read and written through plain pointers, never through the
// read-only data cache (which does not see writes made during the kernel).
//
// Arithmetic: the decision is `iou > thresh` in float32 and has to fall as in
// the plain PyTorch version (ops/boxes.py:iou_xywh_t) bit for bit. Every
// operation is therefore an explicitly rounded intrinsic in that function's
// order, so the compiler cannot contract a*b - c into a fused multiply-add;
// the build also passes -fmad=false and never --use_fast_math. The terms of
// that function that belong to one box alone (its four edges and its area)
// are computed once per box when the row is loaded, with the same
// operations, and a pair whose boxes do not intersect has IoU exactly 0
// without a division. No other shortcut is taken: deciding a pair far from
// the threshold by a product instead of the division was proved, measured
// and dropped, because the kernel took the same time with it and without.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One candidate in shared memory: the per-box terms of iou_xywh_t.
struct Edges { float l, r, t, b; };   // cx -+ w/2, cy -+ h/2
struct Size { float w, h, area, pad; };

// Bytes a row of K candidates takes: edges, sizes, confidence, word.
__host__ __device__ constexpr size_t row_smem(int K) {
  return static_cast<size_t>(K) * (2 * sizeof(float4) + sizeof(float) + sizeof(uint32_t));
}

// The same in float4 words, rounded up, in shared memory or in the
// workspace (whole words keep every row of the workspace aligned).
__host__ __device__ constexpr size_t row_words(int K) {
  return (row_smem(K) + sizeof(float4) - 1) / sizeof(float4);
}

// The terms of iou_xywh_t up to the intersection's sides.
struct Pair { float cw, ch, areas; };

__device__ __forceinline__ Pair pair_of(const Edges ea, const Size sa,
                                        const Edges eb, const Size sb) {
  const float uw = __fsub_rn(fmaxf(ea.r, eb.r), fminf(ea.l, eb.l));
  const float uh = __fsub_rn(fmaxf(ea.b, eb.b), fminf(ea.t, eb.t));
  return Pair{__fsub_rn(__fadd_rn(sa.w, sb.w), uw),
              __fsub_rn(__fadd_rn(sa.h, sb.h), uh),
              __fadd_rn(sa.area, sb.area)};
}

__device__ __forceinline__ bool meets(const Pair p) {
  return !(p.cw <= 0.0f || p.ch <= 0.0f);
}

// iou_xywh_t(a, b) > thresh, decided as the plain version decides it. A pair
// that does not meet has inter = 0 and IoU exactly 0.
__device__ __forceinline__ bool over(const Pair p, const float thresh) {
  if (!meets(p)) return 0.0f > thresh;
  const float inter = __fmul_rn(p.cw, p.ch);
  const float uni = __fsub_rn(p.areas, inter);
  if (!(uni > 0.0f)) return 0.0f > thresh;
  return __fdiv_rn(inter, fmaxf(uni, 1e-12f)) > thresh;
}

// The member bits that the first of the 1 << ls threads of a candidate takes:
// every (1 << ls)-th. The others shift it by their place among the threads.
__host__ __device__ constexpr uint32_t stripe_of(int ls) {
  uint32_t m = 0;
  for (int i = 0; i < 32; i += 1 << ls) m |= 1u << i;
  return m;
}

// Bits of `m` (members g0 + i of a group) whose box overlaps candidate j
// above the threshold; with `first_only` the walk ends at the first one.
__device__ __forceinline__ uint32_t overlap_word(const Edges* sedge, const Size* ssize,
                                                 int g0, int j, uint32_t m,
                                                 const float thresh, bool first_only) {
  uint32_t word = 0;
  if (m) {
    const Edges ej = sedge[j];
    const Size sj = ssize[j];
    do {
      const int i = __ffs(m) - 1;
      m &= m - 1;
      if (over(pair_of(sedge[g0 + i], ssize[g0 + i], ej, sj), thresh)) word |= 1u << i;
    } while (m && !(first_only && word));
  }
  return word;
}

// boxes (R, K, 4) float32 cxcywh, conf-descending within a row;
// dsel (R, K) float32, 0 for masked-out slots; keep (R, K) one byte each.
// 1 << LS threads share one candidate; the block has a multiple of 32 threads.
// With GLOBAL the row's arrays live in `work` (row_words(K) float4 a row)
// instead of dynamic shared memory; nothing else differs.
template <int LS, bool GLOBAL>
__global__ void __launch_bounds__(1024)
nms_rows_kernel(const float4* __restrict__ boxes, const float* __restrict__ dsel,
                uint8_t* __restrict__ keep, int K, float thresh, float4* work) {
  extern __shared__ float4 smem[];
  float4* base = GLOBAL ? work + static_cast<size_t>(blockIdx.x) * row_words(K) : smem;
  Edges* sedge = reinterpret_cast<Edges*>(base);           // K
  Size* ssize = reinterpret_cast<Size*>(base + K);         // K
  float* sconf = reinterpret_cast<float*>(base + 2 * K);   // K, 0 = dead
  uint32_t* sword = reinterpret_cast<uint32_t*>(sconf + K);  // K triangle words
  __shared__ int s_last;
  __shared__ uint32_t s_kept;

  const int tid = threadIdx.x, lane = tid & 31;
  const int threads = blockDim.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * K;

  if (tid == 0) s_last = 0;
  __syncthreads();
  int last = 0;
  for (int j = tid; j < K; j += threads) {
    const float4 b = boxes[row + j];
    // x/2 is exact, written as a multiply by 0.5f
    const float hw = __fmul_rn(b.z, 0.5f), hh = __fmul_rn(b.w, 0.5f);
    sedge[j] = Edges{__fsub_rn(b.x, hw), __fadd_rn(b.x, hw),
                     __fsub_rn(b.y, hh), __fadd_rn(b.y, hh)};
    ssize[j] = Size{b.z, b.w, __fmul_rn(b.z, b.w), 0.0f};
    const float c = dsel[row + j];
    sconf[j] = c;
    if (c > 0.0f) last = j + 1;
  }
  if (last > 0) atomicMax(&s_last, last);
  __syncthreads();
  const int n = s_last;  // candidates past n can neither suppress nor be kept
  // this thread's candidates are mine, mine + per, ...; of a group's members
  // it takes the bit positions in `stripe`
  constexpr int S = 1 << LS;
  const int mine = tid >> LS, per = threads >> LS;
  constexpr uint32_t FIRST = stripe_of(LS);  // evaluated by the compiler
  const uint32_t stripe = FIRST << (tid & (S - 1));

  // (t) every group's triangle; the loop's bound is the same for all lanes
  // of a warp, so the shuffles are taken together
  for (int j0 = (tid - lane) >> LS; j0 < n; j0 += per) {
    const int j = j0 + (lane >> LS);
    const int rel = j & 31;
    uint32_t word = 0;
    if (j < n && sconf[j] > 0.0f) {
      word = overlap_word(sedge, ssize, j - rel, j, ((1u << rel) - 1u) & stripe, thresh, false);
    }
#pragma unroll
    for (int o = 1; o < S; o <<= 1) word |= __shfl_xor_sync(0xffffffffu, word, o);
    if (j < n) sword[j] = word;  // the candidate's threads all write the same word
  }
  __syncthreads();

  for (int g0 = 0; g0 < n; g0 += 32) {
    // live members of the group; every warp works it out alone
    const int jm = g0 + lane;
    const uint32_t gmask = __ballot_sync(0xffffffffu, jm < n && sconf[jm < n ? jm : 0] > 0.0f);
    if (gmask == 0) continue;  // the same in every thread: nothing below writes sconf
    // (b) warp 0 settles the group's members among themselves
    if (tid < 32) {
      bool und = (gmask >> lane) & 1u;
      const uint32_t word = und ? sword[jm] & gmask : 0u;
      bool kept = false;
      for (;;) {
        const uint32_t u = __ballot_sync(0xffffffffu, und);
        if (u == 0) break;
        const uint32_t km = __ballot_sync(0xffffffffu, kept);
        if (und) {
          if (word & km) {
            und = false;
          } else if (!(word & u)) {
            und = false;
            kept = true;
          }
        }
      }
      const uint32_t km = __ballot_sync(0xffffffffu, kept);
      if (((gmask >> lane) & 1u) && !kept) sconf[jm] = 0.0f;
      if (lane == 0) s_kept = km;
    }
    __syncthreads();
    // (c) live candidates behind the group against this thread's share of
    // the kept members
    const uint32_t km = s_kept & stripe;
    if (km) {
      for (int j = g0 + 32 + mine; j < n; j += per) {
        // a candidate's other threads may drop it meanwhile: then this one
        // either sees that and skips it or writes the same 0 once more
        if (sconf[j] > 0.0f && overlap_word(sedge, ssize, g0, j, km, thresh, true)) {
          sconf[j] = 0.0f;
        }
      }
    }
    __syncthreads();
  }

  for (int j = tid; j < K; j += threads) {
    keep[row + j] = sconf[j] > 0.0f ? 1 : 0;
  }
}

template <int LS>
int launch(const void* boxes, const void* dsel, void* keep, int R, int K,
           float thresh, int threads, void* work, cudaStream_t stream) {
  const float4* b = static_cast<const float4*>(boxes);
  const float* d = static_cast<const float*>(dsel);
  uint8_t* k = static_cast<uint8_t*>(keep);
  if (work != nullptr) {
    nms_rows_kernel<LS, true><<<R, threads, 0, stream>>>(
        b, d, k, K, thresh, static_cast<float4*>(work));
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = row_words(K) * sizeof(float4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nms_rows_kernel<LS, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nms_rows_kernel<LS, false><<<R, threads, smem, stream>>>(b, d, k, K, thresh, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// Two threads share a candidate while the block stays within this many
// threads: four blocks of 512 fit an SM, so the 240-320 rows of a batch are
// all resident at once. Longer rows get one thread a candidate.
constexpr int PAIRED_THREADS = 512;

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing. `work` is
// null for a row that fits shared memory; for a longer one it is a 16-byte
// aligned workspace of R * row_words(K) float4 words (the caller's, reused
// from call to call: the kernel writes every slot of a row it reads, so it
// needs no zeroing). Returns the cudaError_t of the launch (0 on success).
extern "C" int fsd_nms_rows(const void* boxes, const void* dsel, void* keep,
                            int R, int K, float thresh, void* work, void* stream) {
  if (R <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int paired = (2 * K + 31) / 32 * 32;
  if (paired <= PAIRED_THREADS) {
    return launch<1>(boxes, dsel, keep, R, K, thresh, paired, work, st);
  }
  const int single = (K + 31) / 32 * 32;
  return launch<0>(boxes, dsel, keep, R, K, thresh, single < 1024 ? single : 1024, work, st);
}
