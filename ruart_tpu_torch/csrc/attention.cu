// Fused multi-head attention for the BERT encoder (sm_90a).
//
// Replaces the TPU kernels of ruart_tpu/ops/attention.py:
//   * _packed_kernel  (reached through grouped_attention(packed=True), the
//     path of every BERT layer),
//   * _grouped_kernel (the same function for head widths the 128-lane
//     bundles reject), and
//   * _mha_kernel     (reached through flash_attention: head-major
//     [B, H, L, D] inputs, a [B, 1, 1, L] key bias, fp32 output).
// Per row b and head h it computes
//   out[b, h] = softmax(q_h k_h^T / sqrt(dh) + bias) v_h
// with fp32 scores, a max-subtracted fp32 softmax and fp32 accumulation.
// The kernel reads q/k/v through element strides for batch, position and
// head, so one body serves both layouts without a copy: the model layout
// [B, L, H*dh] (K1/K2, output in q's type) and the head-major layout
// [B, H, L, D] (K3, output always fp32). The bias is a [B, L] key bias or a
// [B, L, L] per-query (segment) bias.
//
// What bounds it on an H100: at the serving path's shapes (L = 32 packed
// rows or <= 50 question rows, dh = 64) one (row, head) does 4*L*L*dh flops
// on 4*L*dh elements plus its bias, about 8 flop/byte in fp32 -- far below
// the card's ~20 (fp32 CUDA cores) to ~295 (bf16 tensor cores) flop/byte
// balance point, so it is bound by device memory: the least time is
// (q + k + v + out + bias bytes) / 3.35 TB/s. K3 at L 128 does ~32
// flop/byte in fp32 and is bound by the fp32 CUDA-core rate there.
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

// Element strides of one [batch, position, head] layout; the innermost
// (head-width) axis is contiguous.
struct Layout {
  long long batch, pos, head;
};

// DCH = ceil(dh / 32): output columns per lane; shared rows hold 32*DCH
// values (zero-padded past dh). T is the input type, TO the output type.
template <typename T, typename TO, int DCH, bool kBias2d>
__global__ void __launch_bounds__(kWarps * 32)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     TO* __restrict__ out, Layout in, Layout o, int L, int dh,
                     int n_qtiles, float scale) {
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
  const long long base = (long long)b * in.batch + (long long)h * in.head;
  const long long obase = (long long)b * o.batch + (long long)h * o.head;

  for (int i = tid; i < kQueryTile * kWidth; i += kWarps * 32) {
    const int r = i / kWidth, d = i % kWidth, pos = q0 + r;
    qs[r][d] = (pos < L && d < dh) ? to_f32(q[base + pos * in.pos + d]) : 0.f;
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
      const bool inside = pos < L && d < dh;
      const long long off = base + pos * in.pos + d;
      ks[r][d] = inside ? to_f32(k[off]) : 0.f;
      vs[r][d] = inside ? to_f32(v[off]) : 0.f;
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
        if (d < dh) store(&out[obase + qpos * o.pos + d], acc[i][c] / l[i]);
      }
    }
  }
}

template <typename T, typename TO, int DCH>
void launch_dch(const void* q, const void* k, const void* v, const float* bias,
                void* out, int bias_2d, dim3 grid, Layout in, Layout o, int L,
                int dh, int n_qtiles, float scale, cudaStream_t stream) {
  const dim3 block(kWarps * 32);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  TO* ot = static_cast<TO*>(out);
  if (bias_2d) {
    attention_kernel<T, TO, DCH, true><<<grid, block, 0, stream>>>(
        qt, kt, vt, bias, ot, in, o, L, dh, n_qtiles, scale);
  } else {
    attention_kernel<T, TO, DCH, false><<<grid, block, 0, stream>>>(
        qt, kt, vt, bias, ot, in, o, L, dh, n_qtiles, scale);
  }
}

template <typename T, typename TO>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int B, int H, int L, int dh, int bias_2d, Layout in,
           Layout o, float scale, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || H > 65535 || dh <= 0 || dh > 128 ||
      dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int n_qtiles = (L + kQueryTile - 1) / kQueryTile;
  if ((long long)B * n_qtiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * n_qtiles), (unsigned)H);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bias_f = static_cast<const float*>(bias);
  switch ((dh + 31) / 32) {
    case 1:
      launch_dch<T, TO, 1>(q, k, v, bias_f, out, bias_2d, grid, in, o, L, dh,
                           n_qtiles, scale, s);
      break;
    case 2:
      launch_dch<T, TO, 2>(q, k, v, bias_f, out, bias_2d, grid, in, o, L, dh,
                           n_qtiles, scale, s);
      break;
    case 3:
      launch_dch<T, TO, 3>(q, k, v, bias_f, out, bias_2d, grid, in, o, L, dh,
                           n_qtiles, scale, s);
      break;
    default:
      launch_dch<T, TO, 4>(q, k, v, bias_f, out, bias_2d, grid, in, o, L, dh,
                           n_qtiles, scale, s);
      break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K1/K2. q, k, v, out: [B, L, H*dh] contiguous, fp32 (bf16 == 0) or bf16
// (bf16 == 1), out in q's type; bias: fp32 [B, L] (bias_2d == 0) or
// [B, L, L] (bias_2d == 1). The caller checks shapes, types and 1 <= L,
// dh % 8 == 0, dh <= 128. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ruart_attention_rows(const void* q, const void* k,
                                    const void* v, const void* bias, void* out,
                                    int B, int L, int H, int dh, int bias_2d,
                                    int bf16, float scale, void* stream) {
  const long long pitch = (long long)H * dh;
  const Layout rows{(long long)L * pitch, pitch, (long long)dh};
  if (bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, bias, out, B, H, L,
                                                dh, bias_2d, rows, rows, scale,
                                                stream);
  return launch<float, float>(q, k, v, bias, out, B, H, L, dh, bias_2d, rows,
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
    return launch<__nv_bfloat16, float>(q, k, v, bias, out, B, H, L, D, 0, in,
                                        o, scale, stream);
  return launch<float, float>(q, k, v, bias, out, B, H, L, D, 0, in, o, scale,
                              stream);
}
