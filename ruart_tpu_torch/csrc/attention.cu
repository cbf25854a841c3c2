// Fused multi-head attention for the BERT encoder on Hopper's tensor cores
// (sm_90a).
//
// Replaces the TPU kernels of ruart_tpu/ops/attention.py:
//   * _packed_kernel  (:100; reached through grouped_attention(packed=True),
//     the path of every BERT layer),
//   * _grouped_kernel (:54; the same function for head widths the 128-lane
//     bundles reject), and
//   * _mha_kernel     (:36; reached through flash_attention: head-major
//     [B, H, L, D] inputs, a [B, 1, 1, L] key bias, fp32 output).
// Per row b and head h it computes
//   out[b, h] = softmax(q_h k_h^T / sqrt(dh) + bias) v_h
// with fp32 scores, a max-subtracted fp32 softmax, fp32 probabilities and
// fp32 accumulation, as the Pallas bodies do. The kernel reads q/k/v
// through element strides for batch, position and head, so one body serves
// both layouts without a copy: the model layout [B, L, H*dh] (K1/K2 in
// fp32) and the head-major layout [B, H, L, D] (K3, fp32 or bf16 inputs,
// output always fp32). The bias is a [B, L] key bias or a [B, L, L]
// per-query (segment) bias. K1/K2 on bf16 inputs (the BF16 encoder) run in
// a kernel of their own on the bf16 tensor cores, attention_bf16.cu.
//
// What bounds it on an H100. The products run on the tensor cores in
// 3xTF32 (below): three TF32 products per fp32 product, so at best
// 495 / 3 = 165 TFLOP/s. One (row, head) does 4*L*L*dh flops on 4*L*dh
// elements plus its bias: ~8 flop/byte at the serving shapes (L 32 packed
// rows, dh 64, fp32) and ~32 at K3's L 128, both below the card's
// 165e12 / 3.35e12 ~ 49 flop/byte balance point. So every shape the system
// runs is bound by device memory: the least time is (q + k + v + out +
// bias bytes) / 3.35 TB/s. (On the CUDA cores' 67 TFLOP/s, L 128 was bound
// by operations.) mma.sync does not reach the data sheet's TF32 rate,
// though: measured, the products add about as much time as the copies
// take at L 32, and twice as much at L 128.
//
// Design. One block per (row, head, tile of up to 64 queries), with
// min(4, ceil(L / 16)) warps of 16 query rows each (the m of m16n8k8).
// K and V of a (row, head) are read from device memory once per query
// tile: once for L <= 64 (every serving shape), twice at L 128. Blocks
// are numbered heads fastest, so those that run together share rows.
//   * Staging: K, V and the bias come in tiles of 32 keys by 16-byte
//     cp.async (4-byte copies for a bias whose rows are not 16-byte
//     aligned), rows past L and columns past dh zero-filled (source size
//     0). For L > 32 the tiles are double-buffered, so the next tile's
//     copy overlaps this tile's products. Inputs whose pointers or strides
//     are not 16-byte aligned are staged element by element.
//   * The queries skip shared memory: each lane loads its A-fragment values
//     straight into registers while K and V land. The k order of S = Q K^T
//     is permuted inside each 16 dims so that a lane's values are 4
//     neighbours, read as one vector from Q and from K's shared rows (row
//     pitch dh + 16 elements: lanes (g, t) = (lane >> 2, lane & 3) of a
//     phase start at bank 16g + 4t, no conflicts). V's rows have 16 bytes
//     of padding, so the 32-bit loads of lane (g, t) hit bank 8t + g.
//     Shared memory then holds only K, V and the bias: ~24 KB at the
//     serving shape, and registers, not shared memory, set how many blocks
//     an SM keeps (8 of 2 warps there).
//   * Products: mma.sync.m16n8k8 TF32 with the 3xTF32 split for fp32
//     inputs: x = big + small with big = cvt.rna.tf32(x) and
//     small = cvt.rna.tf32(x - big), and a*b ~ small*big + big*small +
//     big*big accumulated in fp32, small terms first (CUTLASS's fast-fp32
//     scheme). That keeps ~fp32 accuracy, where a single TF32 product keeps
//     about three digits. K3's bf16 inputs are exact in TF32: Q K^T takes
//     one product per fragment; its fp32 output keeps P in fp32: two
//     products, P's big and small parts times V.
//   * Softmax on the accumulator fragments (online over key tiles): the
//     C fragment holds a query row's values in one quad of 4 lanes, so the
//     row max takes 2 shuffles and the 16 rows of a warp move together; the
//     row sum is reduced once, in the epilogue.
//   * P stays in registers: the k order of P V is permuted so that column t
//     of the A fragment is key 2t and column t + 4 is key 2t + 1 -- the two
//     keys the lane already holds in S's C fragment -- and V's rows are read
//     in the same order. No shuffle, no shared-memory round trip.
//   * Epilogue: one reciprocal of the row sum per row; lanes t and t ^ 1
//     swap half their C fragment, so that each lane holds four neighbouring
//     outputs of one row, and write them with 16-byte stores through the
//     output layout's strides.
//   * mma.sync, not wgmma: wgmma takes 64-row tiles per warpgroup, which at
//     L 32 would span two (row, head) pairs, and takes its TF32 B operand
//     only K-major from shared memory, so V would need a transpose and
//     both split parts of K and V a place in shared memory. mma.sync keeps
//     the serving shape near half its bytes bound; wgmma is the next step
//     if the products are to go faster, mainly at L 128.
// The finite bias is added as given -- masked keys are never skipped -- so
// a query whose keys are all masked averages over all L keys exactly as
// the TPU kernel does, and a cross-segment key's exp(-10000 + s - max)
// underflows to an exact 0 whichever tile it sits in, so packing stays
// exact. A key past L has score -inf and weight exactly 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRowsPerWarp = 16;  // m of mma.m16n8k8
constexpr int kMaxWarps = 4;
constexpr int kKeyTile = 32;
constexpr int kNT = kKeyTile / 8;  // score n-tiles per key tile
constexpr int kMaxLen = 512;
constexpr unsigned kFull = 0xffffffffu;

// Element strides of one [batch, position, head] layout; the innermost
// (head-width) axis is contiguous.
struct Layout {
  long long batch, pos, head;
};

// Shared-memory row pitches in elements, for dh padded to dp. K rows get
// 16 more elements: the vector fragment loads of a phase's lanes (g, t)
// then start at bank 16g + 4t (fp32) or 8g + 2t (bf16). V rows get 16
// more bytes: the 32-bit loads of lane (g, t) hit bank 8t + g.
__host__ __device__ constexpr int k_pitch(int dp) { return dp + 16; }
template <typename T>
__host__ __device__ constexpr int v_pitch(int dp) {
  return dp + 16 / (int)sizeof(T);
}

// How a launch cuts its work: warps per block, query and key tiles, key
// stages (two when there is more than one key tile), the bias tile's
// pitch (floats; 8 mod 32 keeps its 64-bit reads free of bank conflicts)
// and the dynamic shared memory.
struct Plan {
  int warps, qtile, n_qtiles, ktile, n_ktiles, stages, bpitch, smem;
  int rows;  // rows x query tiles of the launch
};

template <typename T, int DP>
Plan plan(int L, bool bias_2d) {
  Plan p;
  p.warps = (L + kRowsPerWarp - 1) / kRowsPerWarp;
  if (p.warps > kMaxWarps) p.warps = kMaxWarps;
  p.qtile = p.warps * kRowsPerWarp;
  p.n_qtiles = (L + p.qtile - 1) / p.qtile;
  p.ktile = L > kKeyTile ? kKeyTile : (L + 7) / 8 * 8;
  p.n_ktiles = (L + p.ktile - 1) / p.ktile;
  p.stages = p.n_ktiles > 1 ? 2 : 1;
  p.rows = 0;
  p.bpitch = p.ktile + 8;
  p.smem = p.stages *
           (p.ktile * (k_pitch(DP) + v_pitch<T>(DP)) * (int)sizeof(T) +
            (bias_2d ? p.qtile : 1) * p.bpitch * (int)sizeof(float));
  return p;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four neighbouring elements as floats: one 16-byte (fp32) or 8-byte
// (bf16) load from an aligned address.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Four neighbouring output values to an aligned address.
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32; small is 0 when x is exact in TF32.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// c += a b on the tensor cores; a row-major 16x8, b column-major 8x8.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32 (small terms first) when kF32, else in one product
// (bf16 operands are exact in TF32).
template <bool kF32>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&a)[4],
                                     const uint32_t (&a_small)[4],
                                     const uint32_t (&b)[2],
                                     const uint32_t (&b_small)[2]) {
  if (kF32) {
    mma(c, a_small, b);
    mma(c, a, b_small);
  }
  mma(c, a, b);
}

// Asynchronous copies global -> shared; src_bytes < size zero-fills the
// rest.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows [r0, r0 + nrows) of one (row, head) matrix into shared memory
// (pitch in elements), zero past L and past dh. With `vec`, 16-byte
// cp.async (the caller commits and waits); without, element by element.
template <typename T, int DP>
__device__ __forceinline__ void stage(T* dst, int pitch, const T* src,
                                      long long row_stride, int r0, int nrows,
                                      int L, int dh, bool vec) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kChunks = DP / kVec;
  for (int i = threadIdx.x; i < nrows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * kVec, pos = r0 + r;
    T* d = dst + r * pitch + c;
    const bool inside = pos < L && c < dh;  // dh % 8 == 0: whole chunks
    const T* s = src + (inside ? pos * row_stride + c : 0);
    if (vec) {
      cp_async16(d, s, inside ? 16 : 0);
    } else if (inside) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) d[e] = s[e];
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Copy the bias of query rows [r0, r0 + nrows) and keys [k0, k0 + ktile)
// (row_stride 0 and nrows 1 for the key bias) into shared memory, zero
// past L: 16-byte copies when the rows allow them, else 4-byte ones.
__device__ __forceinline__ void stage_bias(float* dst, int pitch,
                                           const float* src,
                                           long long row_stride, int r0,
                                           int nrows, int k0, int ktile,
                                           int L) {
  const int width =
      L % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 ? 4 : 1;
  const int chunks = ktile / width;
  for (int i = threadIdx.x; i < nrows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i % chunks) * width, pos = r0 + r;
    const bool inside = pos < L && k0 + c < L;  // whole chunks when width 4
    const float* s = src + (inside ? pos * row_stride + k0 + c : 0);
    if (width == 4)
      cp_async16(dst + r * pitch + c, s, inside ? 16 : 0);
    else
      cp_async4(dst + r * pitch + c, s, inside ? 4 : 0);
  }
}

// DP: dh padded to a multiple of 32 (zero columns past dh). T is the input
// type; the output is fp32. One block per (row b, query tile, head h).
template <typename T, int DP, bool kBias2d>
__global__ void __launch_bounds__(kMaxWarps * 32)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     float* __restrict__ out, Layout in, Layout o, int L, int dh,
                     Plan p, bool vec, float scale) {
  constexpr bool kF32 = sizeof(T) == 4;  // else bf16: exact in TF32
  constexpr int kKP = k_pitch(DP);
  constexpr int kVP = v_pitch<T>(DP);
  constexpr int kD8 = DP / 8;    // n-tiles of O
  constexpr int kD16 = DP / 16;  // pairs of k-steps of S

  // key, value and bias tiles, `stages` of each
  extern __shared__ __align__(16) unsigned char smem[];
  const int brows = kBias2d ? p.qtile : 1;
  T* ksm = reinterpret_cast<T*>(smem);
  T* vsm = ksm + p.stages * p.ktile * kKP;
  float* bsm = reinterpret_cast<float*>(vsm + p.stages * p.ktile * kVP);

  // heads fastest, so the blocks that run together read neighbouring
  // heads of the same rows; y and z number rows x query tiles
  const int h = blockIdx.x;
  const int r = blockIdx.y + blockIdx.z * gridDim.y;
  if (r >= p.rows) return;
  const int b = r / p.n_qtiles;
  const int q0 = (r % p.n_qtiles) * p.qtile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * kRowsPerWarp;  // this warp's first query
  const long long base = (long long)b * in.batch + (long long)h * in.head;
  const float* bias_b = bias + (long long)b * L * (kBias2d ? L : 1);

  // start the copies of key tile kt into stage s, as one cp.async group
  auto issue = [=](int kt, int s) {
    const int k0 = kt * p.ktile;
    stage<T, DP>(ksm + s * p.ktile * kKP, kKP, k + base, in.pos, k0, p.ktile,
                 L, dh, vec);
    stage<T, DP>(vsm + s * p.ktile * kVP, kVP, v + base, in.pos, k0, p.ktile,
                 L, dh, vec);
    stage_bias(bsm + s * brows * p.bpitch, p.bpitch, bias_b,
               kBias2d ? L : 0, kBias2d ? q0 : 0, brows, k0, p.ktile, L);
    cp_async_commit();
  };
  issue(0, 0);

  // The k order of S = Q K^T is permuted inside each 16 dims 16d..16d+15:
  // lane t's A-fragment columns (t, t + 4) are dims 16d + 4t + (0, 1) in
  // the first k-step and + (2, 3) in the second, so the lane reads its
  // query values and key fragments as 4-vectors. The queries go straight
  // to registers (rows g and g + 8 of the warp), while K and V land.
  float4 qa[kD16], qb[kD16];
#pragma unroll
  for (int d = 0; d < kD16; ++d) {
    const int col = 16 * d + 4 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pos = row0 + g + 8 * i;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (pos < L && col < dh) {
        const T* src = q + base + pos * in.pos + col;
        x = vec ? load4(src)
                : make_float4(to_f32(src[0]), to_f32(src[1]), to_f32(src[2]),
                              to_f32(src[3]));
      }
      if (i)
        qb[d] = x;
      else
        qa[d] = x;
    }
  }

  float acc[kD8][4];
#pragma unroll
  for (int n = 0; n < kD8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int n_iter = p.n_ktiles;
  for (int it = 0; it < n_iter; ++it) {
    const int kt = it % p.n_ktiles;
    if (it + 1 < n_iter) {  // prefetch the next key tile
      issue((it + 1) % p.n_ktiles, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kst = ksm + (it & 1) * p.ktile * kKP;
    const T* vst = vsm + (it & 1) * p.ktile * kVP;
    const float* bst = bsm + (it & 1) * brows * p.bpitch;
    const int nk = min(p.ktile, L - kt * p.ktile);  // keys inside L

    // S = Q K^T: rows g, g + 8 of the warp; keys 8j + 2t, 8j + 2t + 1
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int d = 0; d < kD16; ++d) {
      // split Q again in every key tile: kept out of the loop, the 3xTF32
      // parts would hold twice Q's registers and halve the resident blocks
      asm volatile("" : "+f"(qa[d].x), "+f"(qa[d].y), "+f"(qa[d].z),
                   "+f"(qa[d].w), "+f"(qb[d].x), "+f"(qb[d].y), "+f"(qb[d].z),
                   "+f"(qb[d].w));
      uint32_t a0[4], a0s[4], a1[4], a1s[4];
      split(qa[d].x, a0[0], a0s[0]);
      split(qb[d].x, a0[1], a0s[1]);
      split(qa[d].y, a0[2], a0s[2]);
      split(qb[d].y, a0[3], a0s[3]);
      split(qa[d].z, a1[0], a1s[0]);
      split(qb[d].z, a1[1], a1s[1]);
      split(qa[d].w, a1[2], a1s[2]);
      split(qb[d].w, a1[3], a1s[3]);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (8 * j < nk) {
          const float4 kv = load4(kst + (8 * j + g) * kKP + 16 * d + 4 * t);
          uint32_t b0[2], b0s[2], b1[2], b1s[2];
          split(kv.x, b0[0], b0s[0]);
          split(kv.y, b0[1], b0s[1]);
          split(kv.z, b1[0], b1s[0]);
          split(kv.w, b1[1], b1s[1]);
          mma3<kF32>(s[j], a0, a0s, b0, b0s);
          mma3<kF32>(s[j], a1, a1s, b1, b1s);
        }
      }
    }

    // online softmax on the fragments; a quad of lanes holds one row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = 8 * j + 2 * t;
        // the bias tile is ktile wide: read only the n-tiles inside it
        const float2 bv =
            8 * j < nk
                ? *reinterpret_cast<const float2*>(
                      bst + (kBias2d ? row0 - q0 + g + 8 * i : 0) * p.bpitch +
                      key)
                : make_float2(0.f, 0.f);
        s[j][2 * i] = key < nk ? s[j][2 * i] * scale + bv.x : -INFINITY;
        s[j][2 * i + 1] =
            key + 1 < nk ? s[j][2 * i + 1] * scale + bv.y : -INFINITY;
        mx[i] = fmaxf(mx[i], fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      }
    float corr[2] = {1.f, 1.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      // key tile 0 holds key 0 < L, so the max is finite from here on
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 8 * j < nk ? expf(s[j][e] - m[e >> 1]) : 0.f;
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < kD8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // O += P V. The k order is permuted so that column t of the A fragment
    // is key 2t and column t + 4 key 2t + 1 -- the two keys the lane holds
    // in S's C fragment -- and V's rows are read in the same order.
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (8 * j < nk) {
        const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        uint32_t pb[4], ps[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(pa[e], pb[e], ps[e]);
        const T* vr = vst + (8 * j + 2 * t) * kVP + g;
#pragma unroll
        for (int n = 0; n < kD8; ++n) {
          uint32_t vb[2], vs[2];
          split(to_f32(vr[8 * n]), vb[0], vs[0]);
          split(to_f32(vr[kVP + 8 * n]), vb[1], vs[1]);
          // P is fp32 whatever the input type: its small part counts
          mma(acc[n], ps, vb);
          if (kF32) mma(acc[n], pb, vs);
          mma(acc[n], pb, vb);
        }
      }
    }
    if (it + 1 < n_iter) __syncthreads();  // consumed before refilled
  }

  // epilogue: the row sums, then 16-byte stores straight from registers:
  // lanes t and t ^ 1 swap halves so that an even lane holds four
  // neighbouring values of row g and an odd lane four of row g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  const bool odd = t & 1;
  const int pos = row0 + g + (odd ? 8 : 0);
  float* orow = out + (long long)b * o.batch + (long long)h * o.head +
             pos * o.pos + 4 * (t >> 1);
#pragma unroll
  for (int n = 0; n < kD8; ++n) {
    const float c0 = acc[n][0] * inv[0], c1 = acc[n][1] * inv[0];
    const float c2 = acc[n][2] * inv[1], c3 = acc[n][3] * inv[1];
    const float r0 = __shfl_xor_sync(kFull, odd ? c0 : c2, 1);
    const float r1 = __shfl_xor_sync(kFull, odd ? c1 : c3, 1);
    if (pos < L && 8 * n + 4 * (t >> 1) < dh)
      store4(orow + 8 * n, odd ? make_float4(r0, r1, c2, c3)
                               : make_float4(c0, c1, r0, r1));
  }
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, const float*, float*,
                        Layout, Layout, int, int, Plan, bool, float);

// One kernel of the family, with its shared-memory limit raised once to
// what L 512 needs.
template <typename T, int DP, bool kBias2d>
struct Family {
  static Kernel<T> kernel() { return attention_kernel<T, DP, kBias2d>; }

  static int prepare() {
    static int err = -1;
    if (err < 0)
      err = (int)cudaFuncSetAttribute(
          kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize,
          plan<T, DP>(kMaxLen, kBias2d).smem);
    return err;
  }

  static int launch(const void* q, const void* k, const void* v,
                    const float* bias, void* out, int B, int H, int L, int dh,
                    Layout in, Layout o, bool vec, float scale,
                    cudaStream_t stream) {
    Plan p = plan<T, DP>(L, kBias2d);
    const long long rows = (long long)B * p.n_qtiles;
    if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    p.rows = (int)rows;
    const unsigned y = rows < 65535 ? (unsigned)rows : 65535u;
    const unsigned z = (unsigned)((rows + y - 1) / y);
    const int err = prepare();
    if (err != 0) return err;
    const Kernel<T> fn = kernel();
    fn<<<dim3((unsigned)H, y, z), p.warps * 32, p.smem,
         stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), bias, static_cast<float*>(out), in,
                   o, L, dh, p, vec, scale);
    return (int)cudaGetLastError();
  }

  // blocks one SM keeps resident at length L, or 0 on an error
  static int resident(int L) {
    const Plan p = plan<T, DP>(L, kBias2d);
    int n = 0;
    if (prepare() != 0 ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kernel(), p.warps * 32, p.smem) != cudaSuccess)
      return 0;
    return n;
  }
};

// The segment bias comes only with fp32 inputs (K1/K2): bf16 inputs here
// are K3's, whose bias is a key bias, so no bf16 kernel takes a [B, L, L]
// bias and none is built.
template <typename T, int DP>
int launch_dp(const void* q, const void* k, const void* v, const float* bias,
              void* out, int B, int H, int L, int dh, int bias_2d, Layout in,
              Layout o, bool vec, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    if (bias_2d)
      return Family<T, DP, true>::launch(q, k, v, bias, out, B, H, L, dh,
                                         in, o, vec, scale, stream);
  } else if (bias_2d) {
    return (int)cudaErrorInvalidValue;
  }
  return Family<T, DP, false>::launch(q, k, v, bias, out, B, H, L, dh, in,
                                          o, vec, scale, stream);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int B, int H, int L, int dh, int bias_2d, Layout in,
           Layout o, float scale, void* stream) {
  if (B <= 0 || L <= 0 || L > kMaxLen || H <= 0 || dh <= 0 || dh > 128 ||
      dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies need 16-byte aligned rows; the output is always so
  constexpr long long kVec = 16 / sizeof(T);
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v) &&
                   in.batch % kVec == 0 && in.pos % kVec == 0 &&
                   in.head % kVec == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bias_f = static_cast<const float*>(bias);
  switch ((dh + 31) / 32) {
    case 1:
      return launch_dp<T, 32>(q, k, v, bias_f, out, B, H, L, dh, bias_2d,
                                  in, o, vec, scale, s);
    case 2:
      return launch_dp<T, 64>(q, k, v, bias_f, out, B, H, L, dh, bias_2d,
                                  in, o, vec, scale, s);
    case 3:
      return launch_dp<T, 96>(q, k, v, bias_f, out, B, H, L, dh, bias_2d,
                                  in, o, vec, scale, s);
    default:
      return launch_dp<T, 128>(q, k, v, bias_f, out, B, H, L, dh,
                                   bias_2d, in, o, vec, scale, s);
  }
}

template <typename T, int DP>
int resident_dp(int L, int bias_2d) {
  if constexpr (std::is_same<T, float>::value) {
    if (bias_2d) return Family<T, DP, true>::resident(L);
  } else if (bias_2d) {
    return 0;
  }
  return Family<T, DP, false>::resident(L);
}

template <typename T>
int resident(int L, int dh, int bias_2d) {
  switch ((dh + 31) / 32) {
    case 1:
      return resident_dp<T, 32>(L, bias_2d);
    case 2:
      return resident_dp<T, 64>(L, bias_2d);
    case 3:
      return resident_dp<T, 96>(L, bias_2d);
    default:
      return resident_dp<T, 128>(L, bias_2d);
  }
}

}  // namespace

// K1/K2 in fp32. q, k, v, out: [B, L, H*dh] contiguous fp32; bias: fp32
// [B, L] (bias_2d == 0) or [B, L, L] (bias_2d == 1). The caller checks
// shapes, types and 1 <= L, dh % 8 == 0, dh <= 128. Launches on `stream`
// and returns cudaGetLastError(). bf16 inputs go to
// ruart_attention_bf16_rows (attention_bf16.cu).
extern "C" int ruart_attention_rows(const void* q, const void* k,
                                    const void* v, const void* bias, void* out,
                                    int B, int L, int H, int dh, int bias_2d,
                                    float scale, void* stream) {
  const long long pitch = (long long)H * dh;
  const Layout rows{(long long)L * pitch, pitch, (long long)dh};
  return launch<float>(q, k, v, bias, out, B, H, L, dh, bias_2d, rows,
                              rows, scale, stream);
}

// K3. q, k, v: [B, H, L, D] in fp32 (bf16 == 0) or bf16 (bf16 == 1), read
// through the element strides (stride_b, stride_h, stride_l) they share,
// the D axis contiguous; bias: fp32 [B, L] (the [B, 1, 1, L] key bias);
// out: contiguous fp32 [B, H, L, D] whatever the input type. The caller
// checks shapes, types and strides. Returns cudaGetLastError().
extern "C" int ruart_flash_attention(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     void* out, int B, int H, int L, int D,
                                     long long stride_b, long long stride_h,
                                     long long stride_l, int bf16, float scale,
                                     void* stream) {
  const Layout in{stride_b, stride_l, stride_h};
  const Layout o{(long long)H * L * D, (long long)D, (long long)L * D};
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, bias, out, B, H, L, D, 0, in,
                                        o, scale, stream);
  return launch<float>(q, k, v, bias, out, B, H, L, D, 0, in, o, scale,
                              stream);
}

// Blocks of the kernel that one SM keeps resident for a launch at length L
// and head width dh (flash == 1: the K3 entry's types, fp32 or bf16 inputs;
// flash == 0: K1/K2 in fp32; attention_bf16.cu answers for K1/K2 in bf16),
// or 0 on an error or for bf16 == 1 with flash == 0. A measurement aid; the
// entries above do not use it.
extern "C" int ruart_attention_blocks_per_sm(int L, int dh, int bf16,
                                             int bias_2d, int flash) {
  if (L <= 0 || L > kMaxLen || dh <= 0 || dh > 128 || dh % 8 != 0) return 0;
  if (bf16 && flash) return resident<__nv_bfloat16>(L, dh, bias_2d);
  if (bf16) return 0;
  return resident<float>(L, dh, bias_2d);
}
