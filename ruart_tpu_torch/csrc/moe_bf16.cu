// The sparse expert layer of the Moonlight-16B-A3B (DeepSeek-V3) encoder in
// bf16 on Hopper (sm_90a): the router's selection, the permutation of the
// routed rows by expert, the grouped expert products and the weighted
// combine, all on the device. The JAX package has no such layer, so this
// replaces no TPU kernel; the port's plain twins are in ops/moe.py.
//
// Every kernel reads the routing from device memory: the per-expert counts
// and row offsets are never brought to the host, so a train step that runs
// the layer 26 times stays one CUDA graph (utils/graphs.SignatureGraphs).
//
//   moe_route_kernel     one warp per token: sigmoid of the fp32 router
//                        logits, the top k of score + correction bias (the
//                        bias chooses, the scores weigh), the weights
//                        s / (sum + 1e-20) * scale, and the experts' row
//                        counts (atomics; also into a running load counter)
//   moe_permute_kernel   each block scans the counts into row offsets;
//                        every (token, slot) takes a row of its expert's
//                        range (atomics: the order within an expert is free,
//                        as each row's products are computed alone)
//   moe_gemm_kernel      the grouped product over the experts' row ranges:
//                        <true> gathers the token rows, multiplies by the
//                        stacked gate and up weights [E, 2N, K] and writes
//                        silu(g) * u (each rounded to bf16 where the
//                        published bf16 code rounds); <false> multiplies the
//                        permuted rows by the down weights [E, N, K]
//   moe_combine_kernel   per token, the fp32 sum of its k rows times their
//                        weights, rounded to bf16, plus the shared experts'
//                        output, plus the residual (bf16 adds, in order)
//
// What bounds the products on an H100. At the training cell's 4,352 tokens
// an expert gets ~408 rows, so a weight element feeds ~408 multiply-adds:
// ~400 flop/byte of weights, near the 295 where the bf16 tensor cores
// (989 TFLOP/s) and HBM (3.35 TB/s) balance. Design: one block per (64-row
// tile of one expert, 64-column tile), columns fastest, so the blocks that
// run together share an expert's weights, read from HBM about once and
// then from L2; a block finds its expert by walking the offsets (64 loads
// from L2). Four warps of 16 rows each, mma.sync.m16n8k16 with fp32 sums,
// fragments by ldmatrix from tiles of 32 columns of K in shared memory
// (pitch 40 elements: the eight rows of an ldmatrix phase fall in distinct
// bank groups), three stages of 16-byte cp.async so two loads are in
// flight behind the products. mma.sync and not wgmma: a first kernel that
// is right and simple; the wgmma/TMA form is a later PR's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxExperts = 256;
constexpr int kPerLane = kMaxExperts / 32;
constexpr int kMaxTopK = 16;

constexpr int kBM = 64;      // rows of a tile: 4 warps of 16
constexpr int kBN = 64;      // output columns of a tile
constexpr int kBK = 32;      // K per stage
constexpr int kStages = 3;
constexpr int kWarps = 4;
constexpr int kPitch = kBK + 8;  // elements per tile row in shared memory

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a b on the bf16 tensor cores: a row-major 16x16, b column-major
// 16x8, fp32 accumulation.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// silu(g) * u as the published code computes it on bf16 tensors: the two
// products rounded to bf16, silu in fp32 rounded to bf16, their product
// rounded (by the store).
__device__ __forceinline__ float swiglu(float g, float u) {
  const float gb = round_bf16(g), ub = round_bf16(u);
  return round_bf16(gb / (1.f + expf(-gb))) * ub;
}

__global__ void moe_route_kernel(const float* __restrict__ logits,
                                 const bf16* __restrict__ bias, int T, int E,
                                 int k, float scale, int* __restrict__ idx,
                                 float* __restrict__ weight,
                                 int* __restrict__ counts,
                                 unsigned long long* __restrict__ load) {
  const int token = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (token >= T) return;
  const float* row = logits + (long long)token * E;
  float score[kPerLane], choice[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int e = lane + 32 * i;
    if (e < E) {
      score[i] = 1.f / (1.f + expf(-row[e]));
      choice[i] = score[i] + __bfloat162float(bias[e]);
    } else {
      score[i] = 0.f;
      choice[i] = -INFINITY;
    }
  }
  int mine_e = 0;       // lane j < k keeps pick j
  float mine_s = 0.f, sum = 0.f;
  for (int j = 0; j < k; ++j) {
    // the largest choice left, ties to the lower expert
    float best = -INFINITY, best_s = 0.f;
    int best_e = E;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int e = lane + 32 * i;
      if (e < E && (choice[i] > best || (choice[i] == best && e < best_e))) {
        best = choice[i];
        best_e = e;
        best_s = score[i];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, off);
      const int oe = __shfl_xor_sync(kFull, best_e, off);
      const float os = __shfl_xor_sync(kFull, best_s, off);
      if (ob > best || (ob == best && oe < best_e)) {
        best = ob;
        best_e = oe;
        best_s = os;
      }
    }
    if (best_e >= E) best_e = j;  // NaN scores: any valid expert
    if (lane == j) {
      mine_e = best_e;
      mine_s = best_s;
    }
    sum += best_s;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      if (lane + 32 * i == best_e) choice[i] = -INFINITY;
  }
  if (lane < k) {
    const long long at = (long long)token * k + lane;
    idx[at] = mine_e;
    weight[at] = mine_s / (sum + 1e-20f) * scale;
    atomicAdd(counts + mine_e, 1);
    if (load != nullptr) atomicAdd(load + mine_e, 1ULL);
  }
}

__global__ void moe_permute_kernel(const int* __restrict__ idx, int n_slots,
                                   int k, int E, const int* __restrict__ counts,
                                   int* __restrict__ cursor,
                                   int* __restrict__ offsets,
                                   int* __restrict__ rows,
                                   int* __restrict__ slot_pos) {
  __shared__ int off[kMaxExperts + 1];
  if (threadIdx.x == 0) {
    int at = 0;
    for (int e = 0; e < E; ++e) {
      off[e] = at;
      at += counts[e];
    }
    off[E] = at;
  }
  __syncthreads();
  if (blockIdx.x == 0)
    for (int e = threadIdx.x; e <= E; e += blockDim.x) offsets[e] = off[e];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  const int e = idx[i];
  const int p = off[e] + atomicAdd(cursor + e, 1);
  rows[p] = i / k;
  slot_pos[i] = p;
}

// out[m, :] for the rows m of expert e's range [offsets[e], offsets[e+1]):
// kGateUp: swiglu(A[rows[m]] W_e[:N]^T, A[rows[m]] W_e[N:]^T) with W
// [E, 2N, K]; else A[m] W_e^T with W [E, N, K]. A row-major [*, K].
template <bool kGateUp>
__global__ void __launch_bounds__(kWarps * 32)
    moe_gemm_kernel(const bf16* __restrict__ a, const int* __restrict__ rows,
                    const bf16* __restrict__ w,
                    const int* __restrict__ offsets, int E, int N, int K,
                    bf16* __restrict__ out) {
  constexpr int kB = kGateUp ? 2 : 1;  // weight tiles per stage
  __shared__ __align__(16) bf16 as[kStages][kBM * kPitch];
  __shared__ __align__(16) bf16 bs[kStages][kB][kBN * kPitch];

  // this block's expert and row tile: walk the experts' tile counts
  int t = blockIdx.y, e = -1, m0 = 0, m_end = 0;
  for (int ee = 0; ee < E; ++ee) {
    const int lo = offsets[ee], hi = offsets[ee + 1];
    const int tiles = (hi - lo + kBM - 1) / kBM;
    if (t < tiles) {
      e = ee;
      m0 = lo + t * kBM;
      m_end = hi;
      break;
    }
    t -= tiles;
  }
  if (e < 0) return;
  const int n0 = blockIdx.x * kBN;
  const long long wrows = kGateUp ? 2LL * N : (long long)N;
  const bf16* we = w + (long long)e * wrows * K;

  // the A rows this thread stages, found once
  constexpr int kChunks = kBK / 8;                        // 16-byte chunks
  constexpr int kAPer = kBM * kChunks / (kWarps * 32);    // 2
  const bf16* asrc[kAPer];
  int abytes[kAPer];
#pragma unroll
  for (int i = 0; i < kAPer; ++i) {
    const int r = (threadIdx.x + i * kWarps * 32) / kChunks;
    const int m = m0 + r;
    const bool inside = m < m_end;
    const long long src = inside ? (rows != nullptr ? rows[m] : m) : 0;
    asrc[i] = a + src * K + (threadIdx.x % kChunks) * 8;
    abytes[i] = inside ? 16 : 0;
  }

  auto load_stage = [&](int s, int k0) {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int c = threadIdx.x + i * kWarps * 32;
      cp_async16(&as[s][(c / kChunks) * kPitch + (c % kChunks) * 8],
                 asrc[i] + k0, abytes[i]);
    }
#pragma unroll
    for (int b = 0; b < kB; ++b)
#pragma unroll
      for (int i = 0; i < kBN * kChunks / (kWarps * 32); ++i) {
        const int c = threadIdx.x + i * kWarps * 32;
        const int r = c / kChunks, col = (c % kChunks) * 8;
        cp_async16(&bs[s][b][r * kPitch + col],
                   we + ((long long)b * N + n0 + r) * K + k0 + col, 16);
      }
    cp_async_commit();
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[kB][kBN / 8][4];
#pragma unroll
  for (int b = 0; b < kB; ++b)
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[b][j][q] = 0.f;

  const int nk = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage(s, s * kBK);
    else
      cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 consumed by all
    const int next = kt + kStages - 1;
    if (next < nk)
      load_stage(next % kStages, next * kBK);
    else
      cp_async_commit();
    const int s = kt % kStages;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, &as[s][(warp * 16 + (lane & 15)) * kPitch +
                         (lane >> 4) * 8 + 16 * kk]);
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const bf16* brow = &bs[s][b][((lane & 7) + ((lane >> 4) << 3)) *
                                         kPitch +
                                     ((lane >> 3) & 1) * 8 + 16 * kk];
#pragma unroll
        for (int jj = 0; jj < kBN / 16; ++jj) {
          uint32_t bf[4];
          ldsm_x4(bf, brow + 16 * jj * kPitch);
          mma(acc[b][2 * jj], af, bf[0], bf[1]);
          mma(acc[b][2 * jj + 1], af, bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // C fragment: rows g and g + 8 of the warp, columns 2t and 2t + 1
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + warp * 16 + g + 8 * half;
      if (m >= m_end) continue;
      float v0, v1;
      if (kGateUp) {
        v0 = swiglu(acc[0][j][2 * half], acc[kB - 1][j][2 * half]);
        v1 = swiglu(acc[0][j][2 * half + 1], acc[kB - 1][j][2 * half + 1]);
      } else {
        v0 = acc[0][j][2 * half];
        v1 = acc[0][j][2 * half + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)m * N + n) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// One block per token: out = residual + (bf16(sum_j w_j y[pos_j]) + shared),
// each add rounded to bf16 as the published code adds bf16 tensors; shared
// and residual may be null.
__global__ void moe_combine_kernel(const bf16* __restrict__ y,
                                   const int* __restrict__ slot_pos,
                                   const float* __restrict__ weight,
                                   const bf16* __restrict__ shared,
                                   const bf16* __restrict__ residual, int k,
                                   int D, bf16* __restrict__ out) {
  __shared__ int pos[kMaxTopK];
  __shared__ float wt[kMaxTopK];
  const long long token = blockIdx.x;
  if (threadIdx.x < k) {
    pos[threadIdx.x] = slot_pos[token * k + threadIdx.x];
    wt[threadIdx.x] = weight[token * k + threadIdx.x];
  }
  __syncthreads();
  for (int d = 2 * threadIdx.x; d < D; d += 2 * blockDim.x) {
    float s0 = 0.f, s1 = 0.f;
    for (int j = 0; j < k; ++j) {
      const __nv_bfloat162 v =
          *reinterpret_cast<const __nv_bfloat162*>(y + (long long)pos[j] * D + d);
      s0 = __fadd_rn(s0, __fmul_rn(wt[j], __low2float(v)));
      s1 = __fadd_rn(s1, __fmul_rn(wt[j], __high2float(v)));
    }
    s0 = round_bf16(s0);
    s1 = round_bf16(s1);
    const long long at = token * D + d;
    if (shared != nullptr) {
      const __nv_bfloat162 v =
          *reinterpret_cast<const __nv_bfloat162*>(shared + at);
      s0 = round_bf16(s0 + __low2float(v));
      s1 = round_bf16(s1 + __high2float(v));
    }
    if (residual != nullptr) {
      const __nv_bfloat162 v =
          *reinterpret_cast<const __nv_bfloat162*>(residual + at);
      s0 = __low2float(v) + s0;
      s1 = __high2float(v) + s1;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(s0, s1);
  }
}

}  // namespace

// logits: fp32 [T, E]; bias: bf16 [E]; idx: int32 [T, k]; weight: fp32
// [T, k]; counts: int32 [E], zeroed by the caller; load: uint64 [E] or
// null. E <= 256, 1 <= k <= min(16, E).
extern "C" int ruart_moe_route(const void* logits, const void* bias, int T,
                               int E, int k, float scale, void* idx,
                               void* weight, void* counts, void* load,
                               void* stream) {
  if (T < 0 || E <= 0 || E > kMaxExperts || k <= 0 || k > kMaxTopK || k > E)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  constexpr int kThreads = 256;
  const long long blocks = ((long long)T * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  moe_route_kernel<<<(unsigned)blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const bf16*>(bias), T, E,
      k, scale, static_cast<int*>(idx), static_cast<float*>(weight),
      static_cast<int*>(counts), static_cast<unsigned long long*>(load));
  return (int)cudaGetLastError();
}

// idx: int32 [T, k]; counts: int32 [E]; cursor: int32 [E], zeroed by the
// caller; offsets: int32 [E + 1]; rows, slot_pos: int32 [T * k].
extern "C" int ruart_moe_permute(const void* idx, int T, int k, int E,
                                 const void* counts, void* cursor,
                                 void* offsets, void* rows, void* slot_pos,
                                 void* stream) {
  if (T < 0 || E <= 0 || E > kMaxExperts || k <= 0 || k > kMaxTopK)
    return (int)cudaErrorInvalidValue;
  const long long slots = (long long)T * k;
  if (slots > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  const unsigned blocks =
      slots == 0 ? 1u : (unsigned)((slots + kThreads - 1) / kThreads);
  moe_permute_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), (int)slots, k, E,
      static_cast<const int*>(counts), static_cast<int*>(cursor),
      static_cast<int*>(offsets), static_cast<int*>(rows),
      static_cast<int*>(slot_pos));
  return (int)cudaGetLastError();
}

// a: bf16 [*, K] (gate_up: token rows, read through rows; else the permuted
// rows themselves, rows null); w: bf16 [E, 2N or N, K]; offsets: int32
// [E + 1] on the device, offsets[E] <= M; out: bf16 [M, N]. N % 64 == 0,
// K % 32 == 0, 16-byte aligned a and w.
extern "C" int ruart_moe_gemm(const void* a, const void* rows, const void* w,
                              const void* offsets, int M, int E, int N, int K,
                              int gate_up, void* out, void* stream) {
  if (M < 0 || E <= 0 || E > kMaxExperts || N <= 0 || N % kBN || K <= 0 ||
      K % kBK)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const long long tiles = (M + kBM - 1) / kBM + E;  // each expert: <= 1 more
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(N / kBN), (unsigned)tiles);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* a_ = static_cast<const bf16*>(a);
  const int* r_ = static_cast<const int*>(rows);
  const bf16* w_ = static_cast<const bf16*>(w);
  const int* o_ = static_cast<const int*>(offsets);
  bf16* out_ = static_cast<bf16*>(out);
  if (gate_up)
    moe_gemm_kernel<true><<<grid, kWarps * 32, 0, s>>>(a_, r_, w_, o_, E, N,
                                                         K, out_);
  else
    moe_gemm_kernel<false><<<grid, kWarps * 32, 0, s>>>(a_, r_, w_, o_, E, N,
                                                          K, out_);
  return (int)cudaGetLastError();
}

// y: bf16 [T * k, D] (the permuted rows' outputs); slot_pos: int32 [T, k];
// weight: fp32 [T, k]; shared, residual: bf16 [T, D] or null; out: bf16
// [T, D]. D even.
extern "C" int ruart_moe_combine(const void* y, const void* slot_pos,
                                 const void* weight, const void* shared,
                                 const void* residual, int T, int k, int D,
                                 void* out, void* stream) {
  if (T < 0 || k <= 0 || k > kMaxTopK || D <= 0 || D % 2)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  moe_combine_kernel<<<(unsigned)T, 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(y), static_cast<const int*>(slot_pos),
      static_cast<const float*>(weight), static_cast<const bf16*>(shared),
      static_cast<const bf16*>(residual), k, D, static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}
