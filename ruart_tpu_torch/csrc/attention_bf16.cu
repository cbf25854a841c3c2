// Fused multi-head attention for the BERT encoder in bf16, on Hopper's bf16
// tensor cores (sm_90a).
//
// Replaces, for bf16 inputs, the TPU kernel _packed_kernel of
// ruart_tpu/ops/attention.py (:100; reached through
// grouped_attention(packed=True), the path of every BERT layer under BF16)
// and _grouped_kernel (:54; the same function for head widths the 128-lane
// bundles reject). Per packed row b and head h it computes
//   out[b, h] = softmax(q_h k_h^T * scale + bias) v_h
// for bf16 q/k [B, L, H*dh], v and out [B, L, H*dv] (dv = dh for BERT,
// where scale is 1/sqrt(dh); the Moonlight encoder's latent attention has
// dh 192 = 128 + 64 rope dims and dv 128, scale 1/sqrt(192)), an fp32 bias of [B, L] (key bias) or
// [B, L, L] (per query: the packed segment mask) and a bf16 output: fp32
// scores, a max-subtracted fp32 softmax, the probabilities NORMALIZED and
// rounded to bf16 before P V (as the plain version attention_rows_plain and
// the JAX package's attention_rows_xla cast them to q's type, and as the
// TPU's matrix unit rounds an fp32 P to bf16 at default precision), P V
// summed in fp32 and rounded to bf16. Keeping P in fp32 and dividing at the
// end is a different function here: it moves about a third of the outputs
// one bf16 step away from the plain version.
//
// What bounds it on an H100. One (row, head) does 4*L*L*dh flops on
// 4*L*dh bf16 elements plus its bias: ~16 flop/byte at the serving shape
// (L 32 packed rows, dh 64, segment bias), far below the 989e12 / 3.35e12
// ~ 295 flop/byte where bf16 products at the data sheet's dense rate would
// bound it. So the least time is (q + k + v + out + bias bytes) / 3.35 TB/s
// up to L ~ 300 with a key bias; the L 512 chunks of encode_chunked are
// near the balance point.
//
// Design. One block per (packed row, head, query tile), with W = min(
// ceil(L/16), 4) warps of 16 query rows (the m of m16n8k16). Blocks are
// numbered heads fastest, so the blocks that run together read the same
// rows and the same bias tile, which the first of them brings into L2.
//   * Rows up to L 32 (every serving row) take one key tile, L rounded up
//     to 16, in kernels of their own (kOneTile): Q's fragments die after
//     Q K^T, so their registers are capped for 7 resident blocks at dh 64
//     (min_blocks). Longer rows take tiles of 64 keys, double-buffered, so
//     the next tile's copy overlaps this tile's products.
//   * Staging: Q, K, V and the bias come by 16-byte cp.async (4-byte copies
//     for a bias whose rows are not 16-byte aligned; element by element for
//     q/k/v off 16-byte alignment), rows past L and columns past dh
//     zero-filled. With one key tile V comes in a copy group of its own,
//     which lands while Q K^T and the softmax run. Q/K/V rows have a pitch
//     of DP + 8 elements (DP: dh rounded up to 16): the eight 16-byte rows
//     of an ldmatrix phase then fall in distinct bank groups. The bias
//     tile is swizzled instead of padded (bias_col): at the serving shape
//     a block then takes 17,920 bytes.
//   * Products: mma.sync.m16n8k16 bf16 with fp32 accumulation for Q K^T
//     and for P V: twice the k of the fp32 kernel's m16n8k8 TF32 per
//     instruction, and no conversion. Q's A fragments are loaded once by
//     ldmatrix.x4, K's B fragments by ldmatrix.x4 (two key n-tiles a load),
//     V's by ldmatrix.x4.trans. A dh that is not a multiple of 16 is
//     zero-padded to DP in the k dimension.
//   * Softmax on the accumulator fragments: a quad of 4 lanes holds one
//     query row, so a row max or sum takes 2 shuffles. P must be normalized
//     before it is rounded, so with more than one key tile a first pass over
//     the tiles (Q K^T, the running max and sum; V is not staged) comes
//     before the pass that computes P V: Q K^T is done twice there.
//   * P stays in registers: the C fragments of two score n-tiles are the A
//     fragment of one P V k-step (16 keys), rounded to bf16 pairs. Each
//     P = e / l takes one reciprocal per row and an FMA correction
//     (quotient), not a division.
//   * Epilogue: lanes t and t ^ 1 swap half their C fragment, so that each
//     lane holds four neighbouring outputs of one row: 8-byte stores.
//   * Query/key and value widths apart (DP, DV): the Moonlight encoder's
//     192/128 heads take DP 192, DV 128 (Q's fragments 48 registers, O's
//     64; no register cap). Every BERT width keeps DV = DP, so its code is
//     the same as before the split.
//   * mma.sync, not wgmma: wgmma takes 64-row tiles per warpgroup, which at
//     L 32 would span two (row, head) pairs; mma.sync keeps a warp per 16
//     queries of one head.
// The finite bias is added as given -- masked keys are never skipped -- so a
// query whose keys are all masked averages over all L keys exactly as the
// TPU kernel does, and a cross-segment key's exp(-10000 + s - max)
// underflows to an exact 0, so packing stays exact. A key past L has score
// -inf and weight exactly 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 16;       // query rows per warp: the m of m16n8k16
constexpr int kMaxWarps = 4;    // per block
constexpr int kShortLen = 32;   // up to here one key tile: kOneTile
constexpr int kKeyTile = 64;    // keys per tile beyond kShortLen
constexpr int kMaxLen = 512;
constexpr unsigned kFull = 0xffffffffu;

// Row pitch in elements of the Q, K and V tiles in shared memory.
__host__ __device__ constexpr int pitch(int dp) { return dp + 8; }

// Blocks of kMaxWarps warps an SM should keep (__launch_bounds__), which
// caps the registers at 65536 / (128 n). With one key tile Q's fragments
// die after Q K^T, and at dh <= 64 the kernel fits 72 registers. Longer
// rows keep Q's fragments across the key tiles: no cap.
__host__ __device__ constexpr int min_blocks(int dp, bool one_tile) {
  if (dp > 128) return 1;
  return one_tile ? (dp <= 64 ? 7 : dp <= 96 ? 5 : 4) : 1;
}

// How a launch cuts its work: warps per head, query and key tiles, key
// stages, the bias tile's pitch (floats; at least 32, see bias_col), the
// dynamic shared memory and the rows x query tiles of the launch.
struct Plan {
  int warps, qtile, n_qtiles, ktile, n_ktiles, stages, bpitch, smem, rows;
};

template <int DP, int DV, bool kBias2d, bool kOneTile>
Plan plan(int L) {
  Plan p;
  p.warps = (L + kRows - 1) / kRows;
  if (p.warps > kMaxWarps) p.warps = kMaxWarps;
  p.qtile = p.warps * kRows;
  p.n_qtiles = (L + p.qtile - 1) / p.qtile;
  p.ktile = kOneTile ? (L + 15) / 16 * 16 : kKeyTile;
  p.n_ktiles = (L + p.ktile - 1) / p.ktile;
  p.stages = p.n_ktiles > 1 ? 2 : 1;
  p.bpitch = p.ktile > 32 ? p.ktile : 32;
  p.rows = 0;
  p.smem = ((p.qtile + p.stages * p.ktile) * pitch(DP) +
            p.stages * p.ktile * pitch(DV)) *
               (int)sizeof(bf16) +
           p.stages * (kBias2d ? p.qtile : 1) * p.bpitch * (int)sizeof(float);
  return p;
}

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

// Four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8, and lane (g, t) receives row g, columns 2t and
// 2t + 1 of each (with .trans: column g, rows 2t and 2t + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
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

// e / l from r = 1 / l: the product's residual e - q l (exact in an FMA)
// corrects the quotient to the division's rounding (a million random
// (e, l) of a softmax agree, tests/test_torch_port_bf16_kernel.py). A
// division per
// element costs ten-odd instructions and a slow-path branch: the
// ablation's `recip` variant, P times the reciprocal alone, took 15% less
// time at L 32 and a third less at L 512.
__device__ __forceinline__ float quotient(float e, float l, float r) {
  const float q = e * r;
  return fmaf(fmaf(-q, l, e), r, q);
}

// Two floats rounded to nearest even (as torch's cast) in one bf16 pair,
// the first in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Copy rows [r0, r0 + nrows) of one head into shared memory ([nrows]
// [pitch]), zero past L and past dh. ``src`` points at the head's column of
// position 0. With `vec`, 16-byte cp.async (the caller commits and waits);
// without, element by element.
template <int DP>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src,
                                      long long pos_stride, int r0, int nrows,
                                      int L, int dh, bool vec) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks of a row
  for (int i = threadIdx.x; i < nrows * kChunks; i += blockDim.x) {
    const int c = (i % kChunks) * 8, r = i / kChunks, pos = r0 + r;
    bf16* d = dst + r * pitch(DP) + c;
    const bool inside = pos < L && c < dh;  // dh % 8 == 0: whole chunks
    const bf16* s = src + (inside ? pos * pos_stride + c : 0);
    if (vec) {
      cp_async16(d, s, inside ? 16 : 0);
    } else if (inside) {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = s[e];
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Where column c of row r of the bias tile lies in its row: the 8-column
// groups are swizzled by r mod 4, so the 64-bit reads of rows g and columns
// 8j + 2t by a half warp (g < 4, t < 4) fall in 16 distinct bank pairs with
// a pitch of 32 floats, no padding.
__device__ __forceinline__ int bias_col(int r, int c) {
  return c ^ ((r & 3) << 3);
}

// Copy the bias of query rows [r0, r0 + nrows) and keys [k0, k0 + ktile)
// (row_stride 0 and nrows 1 for the key bias) into shared memory, zero
// past L: 16-byte copies when the rows allow them, else 4-byte ones.
__device__ __forceinline__ void stage_bias(float* dst, int bpitch,
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
    float* d = dst + r * bpitch + bias_col(r, c);
    if (width == 4)
      cp_async16(d, s, inside ? 16 : 0);
    else
      cp_async4(d, s, inside ? 4 : 0);
  }
}

// DP: dh rounded up to 16 (zero columns past dh); DV: dv likewise;
// kOneTile: L <= kShortLen, one key tile. One block per (row b, query
// tile, head).
template <int DP, int DV, bool kBias2d, bool kOneTile>
__global__ void __launch_bounds__(kMaxWarps * 32, min_blocks(DP, kOneTile))
    attention_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const float* __restrict__ bias,
                          bf16* __restrict__ out, int H, int L, int dh, int dv,
                          Plan p, bool vec, float scale) {
  constexpr int kP = pitch(DP);
  constexpr int kPV = pitch(DV);
  constexpr int kD16 = DP / 16;  // k-steps of S = Q K^T
  constexpr int kV16 = DV / 16;  // k-steps of O's n-tile pairs
  constexpr int kD8 = DV / 8;    // n-tiles of O
  constexpr int kNT = (kOneTile ? kShortLen : kKeyTile) / 8;  // S n-tiles

  // Q, then `stages` key tiles of K, of V and of the bias
  extern __shared__ __align__(16) unsigned char smem[];
  const int brows = kBias2d ? p.qtile : 1;
  bf16* qsm = reinterpret_cast<bf16*>(smem);
  bf16* ksm = qsm + p.qtile * kP;
  bf16* vsm = ksm + p.stages * p.ktile * kP;
  float* bsm = reinterpret_cast<float*>(vsm + p.stages * p.ktile * kPV);

  // heads fastest, so the blocks that run together read the same rows; y
  // and z number rows x query tiles
  const int h = blockIdx.x;
  const int r = blockIdx.y + blockIdx.z * gridDim.y;
  if (r >= p.rows) return;
  const int b = r / p.n_qtiles;
  const int q0 = (r % p.n_qtiles) * p.qtile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow = warp * kRows;  // this warp's first query in the tile
  const int g = lane >> 2, t = lane & 3;
  const long long pos_stride = (long long)H * dh;
  const long long base = (long long)b * L * pos_stride + (long long)h * dh;
  const long long vpos_stride = (long long)H * dv;
  const long long vbase = (long long)b * L * vpos_stride + (long long)h * dv;
  const float* bias_b = bias + (long long)b * L * (kBias2d ? L : 1);

  // P must be normalized before it is rounded: with more than one key tile
  // a first pass finds each row's max and sum (Q K^T only, V not staged)
  const int n_ktiles = kOneTile ? 1 : p.n_ktiles;
  const int n_pass = n_ktiles > 1 ? 2 : 1;
  const int n_iter = n_pass * n_ktiles;

  // start the copies of iteration it's key tile into stage s, as one
  // cp.async group (the first group also holds Q)
  auto issue = [&](int it, int s) {
    const int k0 = (it % n_ktiles) * p.ktile;
    stage<DP>(ksm + s * p.ktile * kP, k + base, pos_stride, k0, p.ktile, L,
              dh, vec);
    if (!kOneTile && it >= n_iter - n_ktiles)  // the pass that computes P V
      stage<DV>(vsm + s * p.ktile * kPV, v + vbase, vpos_stride, k0,
                p.ktile, L, dv, vec);
    stage_bias(bsm + s * brows * p.bpitch, p.bpitch, bias_b,
               kBias2d ? L : 0, kBias2d ? q0 : 0, brows, k0, p.ktile, L);
    cp_async_commit();
  };
  stage<DP>(qsm, q + base, pos_stride, q0, p.qtile, L, dh, vec);
  issue(0, 0);
  if (kOneTile) {  // V in a group of its own: it lands while Q K^T runs
    stage<DV>(vsm, v + vbase, vpos_stride, 0, p.ktile, L, dv, vec);
    cp_async_commit();
  }

  uint32_t qf[kD16][4];  // Q's A fragments, rows wrow..wrow+15 of the tile
  float acc[kD8][4];
#pragma unroll
  for (int n = 0; n < kD8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows g and g + 8 of the warp: running max, then the sum (partial per
  // lane until the quad reduces it)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_iter; ++it) {
    const bool pv = it >= n_iter - n_ktiles;
    if (it + 1 < n_iter) {  // prefetch the next key tile
      issue(it + 1, (it + 1) & 1);
      cp_async_wait<1>();
    } else if (kOneTile) {  // Q, K and the bias; V may be in flight
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      const bf16* qrow =
          qsm + (wrow + (lane & 15)) * kP + (lane >> 4) * 8;
#pragma unroll
      for (int d = 0; d < kD16; ++d) ldsm_x4(qf[d], qrow + 16 * d);
    }
    const int s_idx = it & 1;
    const bf16* kst = ksm + s_idx * p.ktile * kP;
    const bf16* vst = vsm + s_idx * p.ktile * kPV;
    const float* bst = bsm + s_idx * brows * p.bpitch;
    const int nk = min(p.ktile, L - (it % n_ktiles) * p.ktile);

    // S = Q K^T: rows g, g + 8 of the warp; keys 8j + 2t, 8j + 2t + 1.
    // One ldmatrix.x4 gives the B fragments of key n-tiles 2jj and
    // 2jj + 1 for one k-step: lanes 0-7 address keys 0-7 at dims 0-7,
    // lanes 8-15 keys 0-7 at dims 8-15, lanes 16-31 keys 8-15 likewise.
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const bf16* krow = kst + ((lane & 7) + ((lane >> 4) << 3)) * kP +
                       ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int d = 0; d < kD16; ++d) {
#pragma unroll
      for (int jj = 0; jj < kNT / 2; ++jj) {
        if (16 * jj < nk) {
          uint32_t kb[4];
          ldsm_x4(kb, krow + 16 * jj * kP + 16 * d);
          mma(s[2 * jj], qf[d], kb[0], kb[1]);
          if (16 * jj + 8 < nk) mma(s[2 * jj + 1], qf[d], kb[2], kb[3]);
        }
      }
    }

    // scale, bias, mask; the row max over this tile
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = 8 * j + 2 * t;
        // the bias tile is ktile wide: read only the n-tiles inside it
        const int brow = kBias2d ? wrow + g + 8 * i : 0;
        const float2 bv =
            8 * j < nk ? *reinterpret_cast<const float2*>(
                             bst + brow * p.bpitch + bias_col(brow, key))
                       : make_float2(0.f, 0.f);
        s[j][2 * i] = key < nk ? s[j][2 * i] * scale + bv.x : -INFINITY;
        s[j][2 * i + 1] =
            key + 1 < nk ? s[j][2 * i + 1] * scale + bv.y : -INFINITY;
        mx[i] = fmaxf(mx[i], fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      }

    // the softmax statistics: the running max, then the exponentials and
    // their sum (with two passes, the second exponentiates against the
    // final max)
    const bool stats = !pv || n_pass == 1;
    if (stats) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        // key tile 0 holds key 0 < L, so the max is finite from here on
        const float m_new = fmaxf(m[i], mx[i]);
        l[i] *= expf(m[i] - m_new);
        m[i] = m_new;
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 8 * j < nk ? expf(s[j][e] - m[e >> 1]) : 0.f;
        if (stats) l[e >> 1] += s[j][e];
      }
    if (stats && it == n_ktiles - 1) {  // the rows' sums are complete
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(kFull, l[i], 1);
        l[i] += __shfl_xor_sync(kFull, l[i], 2);
      }
    }

    // O += P V, P normalized and rounded to bf16. The C fragments of score
    // n-tiles 2kk and 2kk + 1 are the A fragment of k-step kk (keys
    // 16kk..16kk+15). One ldmatrix.x4.trans gives the B fragments of
    // output n-tiles 2dd and 2dd + 1: lanes 0-15 address keys 0-15 at
    // dims 0-7, lanes 16-31 the same keys at dims 8-15.
    if (pv) {
      if (kOneTile) {
        cp_async_wait<0>();
        __syncthreads();
      }
      const bf16* vrow = vst + (lane & 15) * kPV + (lane >> 4) * 8;
      const float r[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
        if (16 * kk < nk) {
          uint32_t a[4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float* sj = s[2 * kk + half];
            a[2 * half] = pack(quotient(sj[0], l[0], r[0]),  // row g
                               quotient(sj[1], l[0], r[0]));
            a[2 * half + 1] = pack(quotient(sj[2], l[1], r[1]),  // row g + 8
                                   quotient(sj[3], l[1], r[1]));
          }
#pragma unroll
          for (int dd = 0; dd < kV16; ++dd) {
            uint32_t vb[4];
            ldsm_x4_trans(vb, vrow + 16 * kk * kPV + 16 * dd);
            mma(acc[2 * dd], a, vb[0], vb[1]);
            mma(acc[2 * dd + 1], a, vb[2], vb[3]);
          }
        }
      }
    }
    if (it + 1 < n_iter) __syncthreads();  // consumed before refilled
  }

  // epilogue: lanes t and t ^ 1 swap halves so that an even lane holds four
  // neighbouring values of row g and an odd lane four of row g + 8
  const bool odd = t & 1;
  const int pos = q0 + wrow + g + (odd ? 8 : 0);
  bf16* orow = out + vbase + pos * vpos_stride + 4 * (t >> 1);
#pragma unroll
  for (int n = 0; n < kD8; ++n) {
    const float c0 = acc[n][0], c1 = acc[n][1];
    const float c2 = acc[n][2], c3 = acc[n][3];
    const float r0 = __shfl_xor_sync(kFull, odd ? c0 : c2, 1);
    const float r1 = __shfl_xor_sync(kFull, odd ? c1 : c3, 1);
    if (pos < L && 8 * n + 4 * (t >> 1) < dv) {
      const uint2 w = odd ? make_uint2(pack(r0, r1), pack(c2, c3))
                          : make_uint2(pack(c0, c1), pack(r0, r1));
      *reinterpret_cast<uint2*>(orow + 8 * n) = w;
    }
  }
}

using Kernel = void (*)(const bf16*, const bf16*, const bf16*, const float*,
                        bf16*, int, int, int, int, Plan, bool, float);

// One kernel of the family, with its shared-memory limit raised once to
// what its longest rows need.
template <int DP, int DV, bool kBias2d, bool kOneTile>
struct Family {
  static Kernel kernel() {
    return attention_bf16_kernel<DP, DV, kBias2d, kOneTile>;
  }

  static Plan plan_for(int L) { return plan<DP, DV, kBias2d, kOneTile>(L); }

  static int prepare() {
    static int err = -1;
    if (err < 0)
      err = (int)cudaFuncSetAttribute(
          kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize,
          plan_for(kOneTile ? kShortLen : kMaxLen).smem);
    return err;
  }

  static int launch(const void* q, const void* k, const void* v,
                    const float* bias, void* out, int B, int H, int L, int dh,
                    int dv, bool vec, float scale, cudaStream_t stream) {
    Plan p = plan_for(L);
    const long long rows = (long long)B * p.n_qtiles;
    if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    p.rows = (int)rows;
    const unsigned y = rows < 65535 ? (unsigned)rows : 65535u;
    const unsigned z = (unsigned)((rows + y - 1) / y);
    const int err = prepare();
    if (err != 0) return err;
    const Kernel fn = kernel();
    fn<<<dim3((unsigned)H, y, z), p.warps * 32, p.smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), bias, static_cast<bf16*>(out), H, L, dh,
        dv, p, vec, scale);
    return (int)cudaGetLastError();
  }

  // blocks one SM keeps resident at length L, or 0 on an error
  static int resident(int L) {
    const Plan p = plan_for(L);
    int n = 0;
    if (prepare() != 0 ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kernel(), p.warps * 32, p.smem) != cudaSuccess)
      return 0;
    return n;
  }
};

// The family member for (L, dh, dv, bias form), passed to `fn` as a value:
// dv == dh pads both to one width of 16 to 128; dh over 128 (up to 192)
// takes dv up to 128 (the latent attention's 192/128).
template <typename Fn>
int dispatch(int L, int dh, int dv, int bias_2d, Fn fn) {
  auto by_widths = [&](auto dp, auto dvp) -> int {
    constexpr int DP = decltype(dp)::value;
    constexpr int DV = decltype(dvp)::value;
    auto by_bias = [&](auto one_tile) -> int {
      constexpr bool kOne = decltype(one_tile)::value;
      if (bias_2d) return fn(Family<DP, DV, true, kOne>());
      return fn(Family<DP, DV, false, kOne>());
    };
    if (L > kShortLen) return by_bias(std::false_type());
    return by_bias(std::true_type());
  };
  auto by_width = [&](auto dp) -> int { return by_widths(dp, dp); };
  if (dh > 128)
    return by_widths(std::integral_constant<int, 192>(),
                     std::integral_constant<int, 128>());
  if (dh <= 16) return by_width(std::integral_constant<int, 16>());
  if (dh <= 32) return by_width(std::integral_constant<int, 32>());
  if (dh <= 48) return by_width(std::integral_constant<int, 48>());
  if (dh <= 64) return by_width(std::integral_constant<int, 64>());
  if (dh <= 96) return by_width(std::integral_constant<int, 96>());
  return by_width(std::integral_constant<int, 128>());
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

bool valid(int L, int dh, int dv) {
  if (L <= 0 || L > kMaxLen || dh <= 0 || dh % 8 || dv <= 0 || dv % 8)
    return false;
  return dh <= 128 ? dv == dh : dh <= 192 && dv <= 128;
}

}  // namespace

// K1/K2 in bf16. q, k: [B, L, H*dh], v, out: [B, L, H*dv] contiguous bf16
// (dv = dh up to 128, or dh up to 192 with dv up to 128); bias: fp32
// [B, L] (bias_2d == 0) or [B, L, L] (bias_2d == 1). The caller checks
// shapes and types. Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for what the kernel does not take.
extern "C" int ruart_attention_bf16_rows_v(const void* q, const void* k,
                                           const void* v, const void* bias,
                                           void* out, int B, int L, int H,
                                           int dh, int dv, int bias_2d,
                                           float scale, void* stream) {
  if (B <= 0 || H <= 0 || !valid(L, dh, dv))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies need 16-byte aligned rows: the row and head strides are
  // multiples of 8 elements, so the base pointers decide
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v);
  const float* bias_f = static_cast<const float*>(bias);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = dispatch(L, dh, dv, bias_2d, [&](auto family) {
    return decltype(family)::launch(q, k, v, bias_f, out, B, H, L, dh, dv,
                                    vec, scale, s);
  });
  return err;
}

// The same with v and out as wide as q and k (dv = dh): the BERT encoder.
extern "C" int ruart_attention_bf16_rows(const void* q, const void* k,
                                         const void* v, const void* bias,
                                         void* out, int B, int L, int H,
                                         int dh, int bias_2d, float scale,
                                         void* stream) {
  if (dh > 128) return (int)cudaErrorInvalidValue;
  return ruart_attention_bf16_rows_v(q, k, v, bias, out, B, L, H, dh, dh,
                                     bias_2d, scale, stream);
}

// Blocks of the bf16 kernel that one SM keeps resident for a launch at
// length L and head width dh, or 0 on an error. A measurement aid; the
// entry above does not use it.
extern "C" int ruart_attention_bf16_blocks_per_sm(int L, int dh,
                                                  int bias_2d) {
  if (!valid(L, dh, dh)) return 0;
  return dispatch(L, dh, dh, bias_2d, [&](auto family) {
    return decltype(family)::resident(L);
  });
}
