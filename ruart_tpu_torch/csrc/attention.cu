// Fused multi-head attention in model layout for the BERT encoder (sm_90a).
//
// Replaces the TPU kernels of ruart_tpu/ops/attention.py:
//   * _packed_kernel  (reached through grouped_attention(packed=True), the
//     path of every BERT layer), and
//   * _grouped_kernel (the same function for head widths the 128-lane
//     bundles reject).
// Per row b and head h it computes
//   out[b, :, h] = softmax(q_h k_h^T / sqrt(dh) + bias) v_h
// on q/k/v laid out [B, L, H*dh] (no head transpose), with a [B, L] key
// bias or a [B, L, L] per-query (segment) bias, fp32 scores, a
// max-subtracted fp32 softmax, fp32 accumulation and the output in q's type
// (fp32 or bf16).
//
// What bounds it on an H100: at the serving path's shapes (L = 32 packed
// rows or <= 50 question rows, dh = 64) one (row, head) does 4*L*L*dh flops
// on 4*L*dh elements plus its bias, about 8 flop/byte in fp32 — far below
// the card's ~20 (fp32 CUDA cores) to ~295 (bf16 tensor cores) flop/byte
// balance point, so it is bound by device memory: the least time is
// (q + k + v + out + bias bytes) / 3.35 TB/s.
//
// Design: one block of 4 warps per (row, head, tile of 16 queries). The
// block stages its query tile and then tiles of 32 keys and values in
// shared memory (converted to fp32), so shared memory stays fixed at
// ~42 KB for every L up to 512 and every dh up to 128; each input element
// is read from device memory once per query tile. One lane owns one key of
// the tile: it computes that key's score, the warp reduces the running max
// and sum (online softmax), and each lane accumulates dh/32 output columns.
// The finite bias is added as given — masked keys are never skipped — so a
// query whose keys are all masked averages over all L keys exactly as the
// TPU kernel does, and a cross-segment key's exp(-10000 + s - max)
// underflows to an exact 0 whichever tile it sits in, so packing stays
// exact. Plain CUDA-core FMAs: tensor-core tiles would not pay at 32x32
// scores; making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kQueriesPerWarp = 4;
constexpr int kQueryTile = kWarps * kQueriesPerWarp;
constexpr int kKeyTile = 32;  // one key per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// DCH = ceil(dh / 32): output columns per lane; shared rows hold 32*DCH
// values (zero-padded past dh).
template <typename T, int DCH, bool kBias2d>
__global__ void __launch_bounds__(kWarps * 32)
    attention_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ bias, T* __restrict__ out,
                          int L, int H, int dh, int n_qtiles, float scale) {
  constexpr int kWidth = 32 * DCH;
  // Q/K row pitch of kWidth + 4 floats: float4 reads by 8 lanes of a phase
  // land on 8 distinct 4-bank groups (no bank conflicts)
  constexpr int kPitch = kWidth + 4;
  __shared__ __align__(16) float qs[kQueryTile][kPitch];
  __shared__ __align__(16) float ks[kKeyTile][kPitch];
  __shared__ __align__(16) float vs[kKeyTile][kWidth];

  const int b = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kQueryTile;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long pitch = (long long)H * dh;  // elements per position
  const long long base = (long long)b * L * pitch + (long long)h * dh;

  for (int i = tid; i < kQueryTile * kWidth; i += kWarps * 32) {
    const int r = i / kWidth, d = i % kWidth, pos = q0 + r;
    qs[r][d] = (pos < L && d < dh) ? to_f32(q[base + pos * pitch + d]) : 0.f;
  }

  float m[kQueriesPerWarp], l[kQueriesPerWarp], acc[kQueriesPerWarp][DCH];
#pragma unroll
  for (int i = 0; i < kQueriesPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += kKeyTile) {
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int i = tid; i < kKeyTile * kWidth; i += kWarps * 32) {
      const int r = i / kWidth, d = i % kWidth, pos = k0 + r;
      const bool in = pos < L && d < dh;
      const long long off = base + pos * pitch + d;
      ks[r][d] = in ? to_f32(k[off]) : 0.f;
      vs[r][d] = in ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();
    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < kQueriesPerWarp; ++i) {
      const int r = warp * kQueriesPerWarp + i;
      const int qpos = q0 + r;
      if (qpos < L) {  // uniform across the warp
        float s = -INFINITY;  // a key past L does not exist: weight 0
        if (key < L) {
          const float4* qr = reinterpret_cast<const float4*>(qs[r]);
          const float4* kr = reinterpret_cast<const float4*>(ks[lane]);
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < kWidth / 4; ++c) {
            const float4 a = qr[c], e = kr[c];
            dot = fmaf(a.x, e.x, dot);
            dot = fmaf(a.y, e.y, dot);
            dot = fmaf(a.z, e.z, dot);
            dot = fmaf(a.w, e.w, dot);
          }
          const float bv = kBias2d
                               ? bias[((long long)b * L + qpos) * L + key]
                               : bias[(long long)b * L + key];
          s = dot * scale + bv;
        }
        // tile 0 always holds key 0 < L, so m_new is finite from here on
        const float m_new = fmaxf(m[i], warp_max(s));
        const float p = expf(s - m_new);
        const float corr = expf(m[i] - m_new);
        l[i] = l[i] * corr + warp_sum(p);
#pragma unroll
        for (int c = 0; c < DCH; ++c) acc[i][c] *= corr;
        for (int j = 0; j < kKeyTile; ++j) {
          const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
          for (int c = 0; c < DCH; ++c)
            acc[i][c] = fmaf(pj, vs[j][lane + 32 * c], acc[i][c]);
        }
        m[i] = m_new;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kQueriesPerWarp; ++i) {
    const int qpos = q0 + warp * kQueriesPerWarp + i;
    if (qpos < L) {
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        const int d = lane + 32 * c;
        if (d < dh) store(&out[base + qpos * pitch + d], acc[i][c] / l[i]);
      }
    }
  }
}

template <typename T, int DCH>
void launch_dch(const void* q, const void* k, const void* v, const float* bias,
                void* out, int bias_2d, dim3 grid, int L, int H, int dh,
                int n_qtiles, float scale, cudaStream_t stream) {
  const dim3 block(kWarps * 32);
  if (bias_2d) {
    attention_rows_kernel<T, DCH, true><<<grid, block, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), bias, static_cast<T*>(out), L, H, dh,
        n_qtiles, scale);
  } else {
    attention_rows_kernel<T, DCH, false><<<grid, block, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), bias, static_cast<T*>(out), L, H, dh,
        n_qtiles, scale);
  }
}

template <typename T>
void launch_type(const void* q, const void* k, const void* v,
                 const float* bias, void* out, int bias_2d, dim3 grid, int L,
                 int H, int dh, int n_qtiles, float scale,
                 cudaStream_t stream) {
  switch ((dh + 31) / 32) {
    case 1:
      launch_dch<T, 1>(q, k, v, bias, out, bias_2d, grid, L, H, dh, n_qtiles,
                       scale, stream);
      break;
    case 2:
      launch_dch<T, 2>(q, k, v, bias, out, bias_2d, grid, L, H, dh, n_qtiles,
                       scale, stream);
      break;
    case 3:
      launch_dch<T, 3>(q, k, v, bias, out, bias_2d, grid, L, H, dh, n_qtiles,
                       scale, stream);
      break;
    default:
      launch_dch<T, 4>(q, k, v, bias, out, bias_2d, grid, L, H, dh, n_qtiles,
                       scale, stream);
      break;
  }
}

}  // namespace

// q, k, v, out: [B, L, H*dh] contiguous, fp32 (bf16 == 0) or bf16
// (bf16 == 1); bias: fp32 [B, L] (bias_2d == 0) or [B, L, L]
// (bias_2d == 1). The caller checks shapes, types and 1 <= L, dh % 8 == 0,
// dh <= 128. Launches on `stream` and returns cudaGetLastError().
extern "C" int ruart_attention_rows(const void* q, const void* k,
                                    const void* v, const void* bias, void* out,
                                    int B, int L, int H, int dh, int bias_2d,
                                    int bf16, float scale, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || H > 65535 || dh <= 0 || dh > 128 ||
      dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int n_qtiles = (L + kQueryTile - 1) / kQueryTile;
  if ((long long)B * n_qtiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * n_qtiles), (unsigned)H);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bias_f = static_cast<const float*>(bias);
  if (bf16) {
    launch_type<__nv_bfloat16>(q, k, v, bias_f, out, bias_2d, grid, L, H, dh,
                               n_qtiles, scale, s);
  } else {
    launch_type<float>(q, k, v, bias_f, out, bias_2d, grid, L, H, dh, n_qtiles,
                       scale, s);
  }
  return (int)cudaGetLastError();
}
