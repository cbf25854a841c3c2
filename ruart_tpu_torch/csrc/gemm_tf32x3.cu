// Y = X W^T + b in fp32 on Hopper's tensor cores (sm_90a), 3xTF32: the
// products of the BERT encoder's six projection and FFN Linears.
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA
// (ruart_tpu/models/bert/model.py, flax nn.Dense). It is added because
// cuBLAS's fp32 SGEMMs (FFMA on the CUDA cores, TF32 off) were 48% of the
// device time of a train step of the shipped ST-VQA conf on an H100.
//
// What bounds it on an H100. Operations: three TF32 products per fp32
// product, so at best 495 / 3 = 165 TFLOP/s. At the encoder's shapes (K
// 768 or 3072, N 768 to 3072, M from a few hundred to several thousand
// tokens) a product does 2 M N K flops on 4 (M K + N K + M N) bytes, 100 to
// 600 flop/byte, well above the card's 165e12 / 3.35e12 ~ 49: the least
// time is 2 M N K / 165 TFLOP/s.
//
// Inputs. X [M, K] with row stride K, W [N, K] (nn.Linear's weight), both
// K-major as TF32 wgmma takes them, so nothing is transposed; b [N] or
// none; Y [M, N] contiguous. One launch takes up to three weights of the
// same [N, K] over the same X (Q, K and V), each with its own bias and
// output. The epilogue adds the bias and, on request, the exact erf gelu
// as F.gelu computes it.
//
// Design.
//   * One block per 128 x 128 output tile: blockIdx.x runs over N's tiles,
//     blockIdx.y over the first weight's M tiles, then the second's, then
//     the third's. The blocks that run together share X's rows, and the
//     weights' outputs are written one after the other, V's last, as three
//     separate products leave them: K1, next, finds more of its q/k/v in
//     L2 (with N fastest across the three weights it ran 7-8% slower;
//     with the weight on blockIdx.z, G1 ran 4-5% slower; both measured).
//   * Shared memory holds a ring of four stages, each an X tile [128 x 32],
//     W's tile [128 x 32] and a second [128 x 32] for W's small part,
//     rows of 128 bytes in TMA's 128-byte swizzle. A stage moves through
//     three mbarriers: full (TMA's bytes landed), ready (W split), empty
//     (both consumers' products read it).
//   * The producer warpgroup: lane 0 of its first warp issues the TMA loads
//     (descriptors built by the host and passed as __grid_constant__
//     parameters) up to four tiles ahead; its other three warps split
//     each W tile in place once it lands: big = cvt.rna.tf32(w) over w,
//     small = cvt.rna.tf32(w - big) into the stage's second buffer
//     (wgmma reads B only from shared memory). The split runs one tile
//     ahead of the products, off their path.
//   * Two consumer warpgroups, 64 rows each: X's values go from shared
//     memory straight into the A fragments of wgmma.m64n128k8 (registers),
//     split there, and each k8 step issues small*big, big*small, big*big,
//     small terms first: the rounding and term order of attention.cu's mma3.
//     A stage's 12 products sum on the tensor cores; each such partial sum
//     is added to the fp32 accumulators on the CUDA cores, which round to
//     nearest (the tensor cores' sums over the whole K lost 4 to 10 times
//     more than cuBLAS FFMA's, measured). While one warpgroup adds, the
//     other's products keep the tensor cores busy. A consumer frees a stage
//     once its products of it are done.
//   * Epilogue from the accumulators: bias, optional gelu, rows past M
//     masked, 8-byte stores.
// Takes K a multiple of 32 and N a multiple of 128; the wrapper checks. It
// allocates nothing, does not synchronize and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBK = 32;          // K of a stage: one 128-byte swizzle row
constexpr int kRow = kBK * 4;    // bytes of a tile row
constexpr int kMaxWeights = 3;
constexpr int kSplitters = 96;   // threads of the producer that split W
constexpr int kCWG = 2;          // consumer warpgroups, 64 rows each
constexpr int kBM = 64 * kCWG;   // rows of an output tile
constexpr int kBN = 128;         // columns of an output tile
constexpr int kStages = 4;
constexpr int kA = kBM * kRow;           // bytes of an X tile
constexpr int kB = kBN * kRow;           // bytes of a W tile
constexpr int kStage = kA + 2 * kB;      // X, W big, W small
constexpr int kThreads = 128 * (kCWG + 1);
// the ring, its barriers, and room to align the ring to 1024 bytes
constexpr int kSmem = kStages * kStage + 3 * kStages * 8 + 1024;

struct Maps {
  CUtensorMap x;
  CUtensorMap w[kMaxWeights];
};

struct Outs {
  float* y[kMaxWeights];
  const float* b[kMaxWeights];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits for the phase of `bar` with this parity to complete. A wait of more
// than kWaitLimitNs (a fault: a stage is never filled or freed) traps, so
// the launch fails with an error instead of holding the card.
constexpr uint64_t kWaitLimitNs = 4000000000ull;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(bar, parity))
    if (global_ns() - t0 > kWaitLimitNs) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// A 2-d tile of `map` at (c0 innermost, c1) into shared memory; its bytes
// count against `bar`'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32 (attention.cu's split).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart. Adding 2 moves the
// start 32 bytes on, to the next k8 step of the same rows.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;             // leading byte offset (unused here)
  d |= (uint64_t)(1024 >> 4) << 32;   // stride byte offset
  d |= (uint64_t)1 << 62;             // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = a b + (scale_d ? d : 0): a the 64 x 8 TF32 A fragment in registers,
// b a descriptor of the [128 x 8] K-major B tile in shared memory.
__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4],
                                      uint64_t b, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// Registers a thread of the producer and of a consumer warpgroup keeps
// after setmaxnreg, with two consumer warpgroups: 128 * 40 + 256 * 232 fit
// the SM's 65,536 (the launch gives each of the 384 threads 168).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

__global__ void __launch_bounds__(kThreads, 1)
    gemm_tf32x3_kernel(__grid_constant__ const Maps maps, const Outs outs,
                       int M, int N, int K, int gelu) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  const uint32_t ring_u32 = smem_u32(ring);
  auto x_tile = [&](int s) { return ring_u32 + s * kStage; };
  auto w_tile = [&](int s) { return ring_u32 + s * kStage + kA; };
  auto full = [&](int s) { return smem_u32(bars + s); };
  auto ready = [&](int s) { return smem_u32(bars + kStages + s); };
  auto empty = [&](int s) { return smem_u32(bars + 2 * kStages + s); };

  const int m_tiles = (M + kBM - 1) / kBM;
  const int which = blockIdx.y / m_tiles;
  const int m0 = (blockIdx.y - which * m_tiles) * kBM;
  const int n0 = blockIdx.x * kBN;
  const int k_tiles = K / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(ready(s), kSplitters);
      mbar_init(empty(s), kCWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (wg == kCWG) {
    // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (tid == 0) {
      const CUtensorMap* wmap = &maps.w[which];
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty(s), ((kt / kStages) - 1) & 1);
        mbar_expect_tx(full(s), kA + kB);
        tma_load(x_tile(s), &maps.x, full(s), kt * kBK, m0);
        tma_load(w_tile(s), wmap, full(s), kt * kBK, n0);
      }
    } else if (tid >= 32) {
      const int sid = tid - 32;
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages;
        mbar_wait(full(s), (kt / kStages) & 1);
        float4* big = reinterpret_cast<float4*>(ring + s * kStage + kA);
        float4* small = big + kB / 16;
        for (int i = sid; i < kB / 16; i += kSplitters) {
          const float4 v = big[i];
          uint32_t b0, b1, b2, b3, s0, s1, s2, s3;
          split(v.x, b0, s0);
          split(v.y, b1, s1);
          split(v.z, b2, s2);
          split(v.w, b3, s3);
          big[i] = make_float4(__uint_as_float(b0), __uint_as_float(b1),
                               __uint_as_float(b2), __uint_as_float(b3));
          small[i] = make_float4(__uint_as_float(s0), __uint_as_float(s1),
                                 __uint_as_float(s2), __uint_as_float(s3));
        }
        fence_proxy_async();
        mbar_arrive(ready(s));
      }
    }
    return;
  }

  // consumer warpgroup `wg`: rows [64 wg, 64 wg + 64) of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kConsumerRegs));
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * warp + g;   // this lane's rows r0, r0 + 8
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;

  // A fragments of one k tile from the swizzled X tile (row r, 16-byte
  // chunk c at chunk c ^ (r & 7); r0 & 7 == g), split
  auto load_a = [&](int s, uint32_t (&ab)[4][4], uint32_t (&as)[4][4]) {
    const float* xs =
        reinterpret_cast<const float*>(ring + s * kStage) + r0 * kBK + t;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c_lo = ((2 * j) ^ g) << 2, c_hi = ((2 * j + 1) ^ g) << 2;
      split(xs[c_lo], ab[j][0], as[j][0]);
      split(xs[8 * kBK + c_lo], ab[j][1], as[j][1]);
      split(xs[c_hi], ab[j][2], as[j][2]);
      split(xs[8 * kBK + c_hi], ab[j][3], as[j][3]);
    }
  };
  // the three products of each k8 step of stage s into d, the first
  // overwriting it
  auto products = [&](int s, float (&d)[kBN / 2], uint32_t (&ab)[4][4],
                      uint32_t (&as)[4][4]) {
    const uint64_t db = desc_sw128(w_tile(s));
    const uint64_t ds = desc_sw128(w_tile(s) + kB);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma(d, as[j], db + 2 * j, j == 0 ? 0 : 1);
      wgmma(d, ab[j], ds + 2 * j);
      wgmma(d, ab[j], db + 2 * j);
    }
    wgmma_commit();
  };

  // Each k tile's products go to `part` on the tensor cores, which is then
  // added to acc on the CUDA cores (rounding to nearest): the tensor
  // cores' own fp32 sums lose more than FFMA's over a long K (measured:
  // 4 to 10 times cuBLAS FFMA's error against fp64 when the whole K was
  // summed there; 0.2 to 0.4 times with a sum per 32).
  float part[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) part[i] = 0.f;
  uint32_t ab[4][4], as[4][4];
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(ready(s), (kt / kStages) & 1);
    load_a(s, ab, as);
    products(s, part, ab, as);
    wgmma_wait<0>();
    fence_acc(part);
    if (tid == 0) mbar_arrive(empty(s));
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] += part[i];
  }

  // epilogue: acc[4j + {0,1,2,3}] = (row r0, cols 8j + 2t, +1), (r0 + 8, ...)
  float* y = outs.y[which];
  const float* bias = outs.b[which];
  const int row0 = m0 + r0;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    float2 bv = make_float2(0.f, 0.f);
    if (bias != nullptr) bv = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      float v0 = acc[4 * j + 2 * h] + bv.x;
      float v1 = acc[4 * j + 2 * h + 1] + bv.y;
      if (gelu) {
        // F.gelu's exact form: x * 0.5 * (1 + erf(x * M_SQRT1_2))
        const float a = 0.70710678118654752440f;
        v0 = v0 * 0.5f * (1.0f + erff(v0 * a));
        v1 = v1 * 0.5f * (1.0f + erff(v1 * a));
      }
      if (row < M)
        *reinterpret_cast<float2*>(y + (size_t)row * N + col) =
            make_float2(v0, v1);
    }
  }
}

// A 2-d fp32 tensor map over a row-major [rows, cols] matrix, boxes of
// [box_rows, 32] in the 128-byte swizzle.
CUresult encode(CUtensorMap* map, const void* base, int rows, int cols,
                int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// Y_i = X W_i^T + b_i (gelu'd when gelu != 0) for i < n_weights (1 to 3):
// x [M, K], w[i] [N, K], b[i] [N] or null, y[i] [M, N], all fp32,
// contiguous and 16-byte aligned; K % 32 == 0, N % 128 == 0, n_weights
// times M's tiles of 128 rows at most 65,535 (the caller checks shapes and
// types). Returns cudaGetLastError(), or 10000 + the
// CUresult of a failed tensor map.
extern "C" int ruart_gemm_tf32x3(const void* x, int M, int K,
                                 const void* const* w, const void* const* b,
                                 void* const* y, int n_weights, int N,
                                 int gelu, void* stream) {
  const int m_tiles = (M + kBM - 1) / kBM;
  if (n_weights < 1 || n_weights > kMaxWeights || M < 1 || K % kBK != 0 ||
      K < kBK || N < 1 || N % kBN != 0 || m_tiles > 65535 / n_weights)
    return (int)cudaErrorInvalidValue;
  // per launch: the attribute belongs to the current device's context
  const cudaError_t attr = cudaFuncSetAttribute(
      gemm_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return (int)attr;
  Maps maps;
  Outs outs;
  CUresult r = encode(&maps.x, x, M, K, kBM);
  for (int i = 0; i < kMaxWeights; ++i) {
    const int src = i < n_weights ? i : 0;
    if (r == CUDA_SUCCESS) r = encode(&maps.w[i], w[src], N, K, kBN);
    outs.y[i] = static_cast<float*>(y[src]);
    outs.b[i] = static_cast<const float*>(b[src]);
  }
  if (r != CUDA_SUCCESS) return 10000 + (int)r;
  const dim3 grid(N / kBN, n_weights * m_tiles);
  gemm_tf32x3_kernel<<<grid, kThreads, kSmem,
                       static_cast<cudaStream_t>(stream)>>>(maps, outs, M, N,
                                                            K, gelu);
  return (int)cudaGetLastError();
}
