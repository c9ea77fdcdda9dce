// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (the Pallas online-softmax forward); the backward kernels have no TPU
// counterpart (the Pallas kernel is forward only, its gradient reference is
// jax.grad of repro.kernels.ref.attention).
//
// Layout: q, o, dq (B, S, H, hd); k, v, dk, dv (B, S, K, hd), all contiguous;
// H % K == 0 and query head h reads kv head h / (H / K) (GQA without
// expanded heads in memory).  lse and delta are (B, H, S) float32.
// Inputs are float32 or bfloat16; all arithmetic is float32 and every
// output is written in the input dtype.  Masks: causal (kpos <= qpos),
// optional sliding window (kpos > qpos - window) and the ragged tail
// (pos < S); kv tiles a q tile cannot see are skipped as a whole.
//
// What bounds it on this card: at the main path's shape (B 2, S 1024, 20
// heads of 128, causal, bf16) the forward does ~255 operations per byte it
// must move, just under the H100's ridge of ~295, so moving bytes bounds it
// (12.6 us); the backward does ~2.5x the operations on ~2x the bytes, so
// the tensor cores' rate bounds it (16 us dq, 22 us dk/dv).  This first
// version does the arithmetic in float32 FMA on the CUDA cores (67 TFLOP/s
// peak, not 989), from shared-memory tiles held in float32 with one padding
// column so that the inner loops read without bank conflicts, and a 4 x k
// register block per thread.  So FMA issue and shared-memory reads bound
// it, far above either bound (times in PERF.md); mma/wgmma tiles fed by
// TMA are the next step.
//
// Four kernels:
//   flash_fwd       one CTA per (q tile, head, batch); the kv loop runs inside
//                   the CTA (the TPU's sequential grid axis); running max, sum
//                   and accumulator in f32; writes o and the row logsumexp.
//   flash_bwd_delta delta = rowsum(dO * O), one warp per row.
//   flash_bwd_dkdv  one CTA per (kv tile, kv head, batch); loops over the G
//                   query heads of its group and the q tiles the mask allows,
//                   so dk/dv of a GQA group are reduced with no atomics.
//   flash_bwd_dq    one CTA per (q tile, head, batch), looping over kv tiles.
//
// Every entry point launches on the stream it is given and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;  // 16 x 16 thread grid

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Reduction over the 16 lanes that share a row (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows [row0, row0 + ROWS) of one head into dst[r * LD + d] as f32,
// multiplied by `mul`; rows at or past S are zero.
template <typename T, int ROWS, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int S,
                                          int row_stride, float mul) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += THREADS) {
    int r = idx / HD, d = idx - r * HD;
    int pos = row0 + r;
    dst[r * LD + d] = pos < S ? to_f(src[(size_t)pos * row_stride + d]) * mul : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int causal, int window) {
  return qpos < S && kpos < S && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// kv tiles (of C rows) that q rows [q0, q0 + R) can see.
__device__ __forceinline__ void kv_range(int q0, int R, int C, int S, int causal, int window,
                                         int* lo, int* hi) {
  int last = (S + C - 1) / C - 1;
  if (causal) last = min(last, (q0 + R - 1) / C);
  int first = 0;
  if (window > 0) first = max(0, q0 - window + 1) / C;
  *lo = first;
  *hi = last;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
template <typename T, int HD, int R, int C>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int S, int H, int KH, int causal,
                 int window, float scale) {
  constexpr int LD = HD + 1, LP = C + 1;
  constexpr int RM = R / 16, CN = C / 16, DN = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + R * LD;
  float* Vs = Ks + C * LD;
  float* Ps = Vs + C * LD;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * R;
  const int kh = h / (H / KH);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qstride = H * HD, kstride = KH * HD;
  const T* qb = q + ((size_t)b * S * H + h) * HD;
  const T* kb = k + ((size_t)b * S * KH + kh) * HD;
  const T* vb = v + ((size_t)b * S * KH + kh) * HD;

  load_tile<T, R, HD>(Qs, qb, q0, S, qstride, scale);

  float acc[RM][DN], m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  int lo, hi;
  kv_range(q0, R, C, S, causal, window, &lo, &hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * C;
    __syncthreads();
    load_tile<T, C, HD>(Ks, kb, k0, S, kstride, 1.f);
    load_tile<T, C, HD>(Vs, vb, k0, S, kstride, 1.f);
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = Qs[(ty * RM + i) * LD + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q0 + ty * RM + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        if (!visible(qpos, k0 + tx + 16 * j, S, causal, window)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = visible(qpos, k0 + tx + 16 * j, S, causal, window)
                            ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * RM + i) * LP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      float pv[RM], vv[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = Ps[(ty * RM + i) * LP + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) vv[j] = Vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qpos = q0 + ty * RM + i;
    if (qpos >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* ob = o + (((size_t)b * S + qpos) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < DN; ++j) ob[tx + 16 * j] = from_f<T>(acc[i][j] / lc);
    if (tx == 0) lse[((size_t)b * H + h) * S + qpos] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// backward: delta = rowsum(dO * O)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int S, int H, int hd) {
  const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);  // (b, s, h)
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* ob = o + (size_t)row * hd;
  const T* db = dout + (size_t)row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f(ob[d]), to_f(db[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H, bs = row / H, s = bs % S, b = bs / S;
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// backward: dq.  P = exp(s - lse), dS = P * (dO.V - delta), dq = scale * dS K.
// ---------------------------------------------------------------------------
template <typename T, int HD, int R, int C>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int S, int H, int KH,
                    int causal, int window, float scale) {
  constexpr int LD = HD + 1, LP = C + 1;
  constexpr int RM = R / 16, CN = C / 16, DN = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + R * LD;
  float* Ks = dOs + R * LD;
  float* Vs = Ks + C * LD;
  float* dSs = Vs + C * LD;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * R;
  const int kh = h / (H / KH);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qstride = H * HD, kstride = KH * HD;
  const size_t head_off = ((size_t)b * S * H + h) * HD;
  const T* kb = k + ((size_t)b * S * KH + kh) * HD;
  const T* vb = v + ((size_t)b * S * KH + kh) * HD;
  const float* lseb = lse + ((size_t)b * H + h) * S;
  const float* deltab = delta + ((size_t)b * H + h) * S;

  load_tile<T, R, HD>(Qs, q + head_off, q0, S, qstride, scale);
  load_tile<T, R, HD>(dOs, dout + head_off, q0, S, qstride, 1.f);

  float lse_r[RM], delta_r[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qpos = q0 + ty * RM + i;
    lse_r[i] = qpos < S ? lseb[qpos] : 0.f;
    delta_r[i] = qpos < S ? deltab[qpos] : 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  int lo, hi;
  kv_range(q0, R, C, S, causal, window, &lo, &hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * C;
    __syncthreads();
    load_tile<T, C, HD>(Ks, kb, k0, S, kstride, 1.f);
    load_tile<T, C, HD>(Vs, vb, k0, S, kstride, 1.f);
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; ++d) {
      float qv[RM], ov[RM], kv[CN], vv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        qv[i] = Qs[(ty * RM + i) * LD + d];
        ov[i] = dOs[(ty * RM + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        kv[j] = Ks[(tx + 16 * j) * LD + d];
        vv[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q0 + ty * RM + i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = visible(qpos, k0 + tx + 16 * j, S, causal, window)
                            ? expf(s[i][j] - lse_r[i]) : 0.f;
        dSs[(ty * RM + i) * LP + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      float ds[RM], kv[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) ds[i] = dSs[(ty * RM + i) * LP + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) kv[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(ds[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qpos = q0 + ty * RM + i;
    if (qpos >= S) continue;
    T* db = dq + (((size_t)b * S + qpos) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < DN; ++j) db[tx + 16 * j] = from_f<T>(acc[i][j] * scale);
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv.  Works on the transposed tiles (kv rows x q columns):
// dv = P^T dO, dk = dS^T (scale * q), summed over the G heads of the group.
// ---------------------------------------------------------------------------
template <typename T, int HD, int R, int C>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KH, int causal,
                      int window, float scale) {
  constexpr int LD = HD + 1, LP = C + 1;
  constexpr int RM = R / 16, CN = C / 16, DN = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + R * LD;
  float* Qs = Vs + R * LD;
  float* dOs = Qs + C * LD;
  float* PT = dOs + C * LD;
  float* dST = PT + R * LP;

  const int b = blockIdx.z, kh = blockIdx.y, k0 = blockIdx.x * R;
  const int G = H / KH;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qstride = H * HD, kstride = KH * HD;
  const size_t kv_off = ((size_t)b * S * KH + kh) * HD;

  load_tile<T, R, HD>(Ks, k + kv_off, k0, S, kstride, 1.f);
  load_tile<T, R, HD>(Vs, v + kv_off, k0, S, kstride, 1.f);

  float dk_acc[RM][DN], dv_acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nqt = (S + C - 1) / C;
  const int qt_lo = causal ? k0 / C : 0;
  const int qt_hi = window > 0 ? min(nqt - 1, (k0 + R + window - 2) / C) : nqt - 1;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t head_off = ((size_t)b * S * H + h) * HD;
    const float* lseb = lse + ((size_t)b * H + h) * S;
    const float* deltab = delta + ((size_t)b * H + h) * S;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * C;
      __syncthreads();
      load_tile<T, C, HD>(Qs, q + head_off, q0, S, qstride, scale);
      load_tile<T, C, HD>(dOs, dout + head_off, q0, S, qstride, 1.f);
      float lse_c[CN], delta_c[CN];
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int qpos = q0 + tx + 16 * j;
        lse_c[j] = qpos < S ? lseb[qpos] : 0.f;
        delta_c[j] = qpos < S ? deltab[qpos] : 0.f;
      }
      __syncthreads();

      float s[RM][CN], dp[RM][CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < HD; ++d) {
        float kv[RM], vv[RM], qv[CN], ov[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          kv[i] = Ks[(ty * RM + i) * LD + d];
          vv[i] = Vs[(ty * RM + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          qv[j] = Qs[(tx + 16 * j) * LD + d];
          ov[j] = dOs[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int kpos = k0 + ty * RM + i;
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const float p = visible(q0 + tx + 16 * j, kpos, S, causal, window)
                              ? expf(s[i][j] - lse_c[j]) : 0.f;
          PT[(ty * RM + i) * LP + tx + 16 * j] = p;
          dST[(ty * RM + i) * LP + tx + 16 * j] = p * (dp[i][j] - delta_c[j]);
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int c = 0; c < C; ++c) {
        float p[RM], ds[RM], ov[DN], qv[DN];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          p[i] = PT[(ty * RM + i) * LP + c];
          ds[i] = dST[(ty * RM + i) * LP + c];
        }
#pragma unroll
        for (int j = 0; j < DN; ++j) {
          ov[j] = dOs[c * LD + tx + 16 * j];
          qv[j] = Qs[c * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < DN; ++j) {
            dv_acc[i][j] = fmaf(p[i], ov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(ds[i], qv[j], dk_acc[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int kpos = k0 + ty * RM + i;
    if (kpos >= S) continue;
    const size_t off = (((size_t)b * S + kpos) * KH + kh) * HD;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      dk[off + tx + 16 * j] = from_f<T>(dk_acc[i][j]);
      dv[off + tx + 16 * j] = from_f<T>(dv_acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side: tile sizes per head dim, dispatch on (dtype, hd)
// ---------------------------------------------------------------------------
// R rows per CTA and C rows per inner tile: 64 x 64 up to hd 128; 32 x 32 at
// hd 256, where the four float32 tiles of the backward would not fit in the
// 227 KB a block may hold.
template <int HD> struct Tiles { static constexpr int R = 64, C = 64; };
template <> struct Tiles<256> { static constexpr int R = 32, C = 32; };

template <int HD> constexpr size_t fwd_smem() {
  return sizeof(float) * ((Tiles<HD>::R + 2 * Tiles<HD>::C) * (HD + 1) +
                          Tiles<HD>::R * (Tiles<HD>::C + 1));
}
template <int HD> constexpr size_t dq_smem() {
  return sizeof(float) * ((2 * Tiles<HD>::R + 2 * Tiles<HD>::C) * (HD + 1) +
                          Tiles<HD>::R * (Tiles<HD>::C + 1));
}
template <int HD> constexpr size_t dkdv_smem() {
  return sizeof(float) * ((2 * Tiles<HD>::R + 2 * Tiles<HD>::C) * (HD + 1) +
                          2 * Tiles<HD>::R * (Tiles<HD>::C + 1));
}

struct Args {
  const void *q, *k, *v, *dout;
  void *o, *dq, *dk, *dv;
  float *lse, *delta;
  int B, S, H, KH, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD> cudaError_t launch_fwd(const Args& a) {
  constexpr int R = Tiles<HD>::R, C = Tiles<HD>::C;
  auto kern = flash_fwd_kernel<T, HD, R, C>;
  constexpr size_t smem = fwd_smem<HD>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.S + R - 1) / R, a.H, a.B);
  kern<<<grid, THREADS, smem, a.stream>>>((const T*)a.q, (const T*)a.k, (const T*)a.v,
                                          (T*)a.o, a.lse, a.S, a.H, a.KH, a.causal, a.window,
                                          a.scale);
  return cudaGetLastError();
}

template <typename T, int HD> cudaError_t launch_dq(const Args& a) {
  constexpr int R = Tiles<HD>::R, C = Tiles<HD>::C;
  auto kern = flash_bwd_dq_kernel<T, HD, R, C>;
  constexpr size_t smem = dq_smem<HD>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.S + R - 1) / R, a.H, a.B);
  kern<<<grid, THREADS, smem, a.stream>>>((const T*)a.q, (const T*)a.k, (const T*)a.v,
                                          (const T*)a.dout, a.lse, a.delta, (T*)a.dq, a.S,
                                          a.H, a.KH, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD> cudaError_t launch_dkdv(const Args& a) {
  constexpr int R = Tiles<HD>::R, C = Tiles<HD>::C;
  auto kern = flash_bwd_dkdv_kernel<T, HD, R, C>;
  constexpr size_t smem = dkdv_smem<HD>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.S + R - 1) / R, a.KH, a.B);
  kern<<<grid, THREADS, smem, a.stream>>>((const T*)a.q, (const T*)a.k, (const T*)a.v,
                                          (const T*)a.dout, a.lse, a.delta, (T*)a.dk,
                                          (T*)a.dv, a.S, a.H, a.KH, a.causal, a.window,
                                          a.scale);
  return cudaGetLastError();
}

template <template <typename, int> class L> struct Dispatch {
  template <typename T> static cudaError_t by_hd(int hd, const Args& a) {
    switch (hd) {
      case 32: return L<T, 32>::run(a);
      case 64: return L<T, 64>::run(a);
      case 128: return L<T, 128>::run(a);
      case 256: return L<T, 256>::run(a);
      default: return cudaErrorInvalidValue;
    }
  }
  static cudaError_t run(int dtype, int hd, const Args& a) {
    if (dtype == 0) return by_hd<float>(hd, a);
    if (dtype == 1) return by_hd<__nv_bfloat16>(hd, a);
    return cudaErrorInvalidValue;
  }
};
template <typename T, int HD> struct Fwd { static cudaError_t run(const Args& a) { return launch_fwd<T, HD>(a); } };
template <typename T, int HD> struct Dq { static cudaError_t run(const Args& a) { return launch_dq<T, HD>(a); } };
template <typename T, int HD> struct Dkdv { static cudaError_t run(const Args& a) { return launch_dkdv<T, HD>(a); } };

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window <= 0 means no sliding window.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         int B, int S, int H, int KH, int hd, int causal, int window,
                         float scale, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse;
  a.B = B; a.S = S; a.H = H; a.KH = KH; a.causal = causal; a.window = window;
  a.scale = scale; a.stream = (cudaStream_t)stream;
  return (int)Dispatch<Fwd>::run(dtype, hd, a);
}

extern "C" int flash_bwd_delta(const void* o, const void* dout, float* delta, int B, int S,
                               int H, int hd, int dtype, void* stream) {
  const int rows = B * S * H;
  dim3 grid((rows + THREADS / 32 - 1) / (THREADS / 32));
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    flash_bwd_delta_kernel<float><<<grid, THREADS, 0, st>>>((const float*)o,
                                                            (const float*)dout, delta, rows,
                                                            S, H, hd);
  else if (dtype == 1)
    flash_bwd_delta_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, delta, rows, S, H, hd);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq, int B, int S,
                            int H, int KH, int hd, int causal, int window, float scale,
                            int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = (float*)lse; a.delta = (float*)delta;
  a.dq = dq; a.B = B; a.S = S; a.H = H; a.KH = KH; a.causal = causal; a.window = window;
  a.scale = scale; a.stream = (cudaStream_t)stream;
  return (int)Dispatch<Dq>::run(dtype, hd, a);
}

extern "C" int flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, void* dk, void* dv, int B,
                              int S, int H, int KH, int hd, int causal, int window,
                              float scale, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = (float*)lse; a.delta = (float*)delta;
  a.dk = dk; a.dv = dv; a.B = B; a.S = S; a.H = H; a.KH = KH; a.causal = causal;
  a.window = window; a.scale = scale; a.stream = (cudaStream_t)stream;
  return (int)Dispatch<Dkdv>::run(dtype, hd, a);
}
