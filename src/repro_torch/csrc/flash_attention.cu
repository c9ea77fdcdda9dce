// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (the Pallas online-softmax forward); the backward kernels have no TPU
// counterpart (the Pallas kernel is forward only, its gradient reference is
// jax.grad of repro.kernels.ref.attention).
//
// Layout: q, o, dq (B, Sq, H, hd); k, v, dk, dv (B, Skv, K, hd), all
// contiguous; H % K == 0 and query head h reads kv head h / (H / K) (GQA
// without expanded heads in memory).  lse and delta are (B, H, Sq) float32.
// Inputs are float32 or bfloat16; all sums are float32 (bf16 products on
// the tensor cores accumulate in float32) and every output is written in the
// input dtype.  Masks: causal (kpos <= qpos),
// optional sliding window (kpos > qpos - window) and the ragged tails
// (qpos < Sq, kpos < Skv); kv tiles a q tile cannot see are skipped as a
// whole.  Sq != Skv (cross-attention: decoder queries on encoder states,
// down to one query token in decode) comes only without causal mask or
// window (the wrapper refuses the rest), so the causal tile bounds below
// only ever see Sq == Skv.
//
// What bounds it on this card: at the main path's shape (B 2, S 1024, 20
// heads of 128, causal, bf16) the forward does ~255 operations per byte it
// must move, just under the H100's ridge of ~295, so moving bytes bounds it
// (12.6 us); the backward does ~2.5x the operations on ~2x the bytes, so
// the tensor cores' rate bounds it (16 us dq, 22 us dk/dv).  delta moves
// bytes and does almost nothing with them (6.3 us for its 21 MB).
//
// The float32 kernels (forward, dq, dk/dv) do their arithmetic in float32
// FMA on the CUDA cores (67 TFLOP/s peak, not 989), from shared-memory tiles
// held in float32 with one padding column so that the inner loops read
// without bank conflicts, and a 4 x k register block per thread: FMA issue
// and shared-memory reads bound them, far above either bound (times in
// PERF.md).  float32 stays there because TF32 would not meet its 2e-4 check.
//
// The bfloat16 kernels (flash_fwd_mma, flash_bwd_dq_mma, flash_bwd_dkdv_mma)
// run on the tensor cores: every product is mma.sync.m16n8k16 bf16 -> f32,
// with operands read by ldmatrix from bf16 shared tiles whose rows are
// padded by 16 bytes (no bank conflicts).  Each warp owns 16 rows: the
// accumulators of its S (and dP) block (m16n8, f32) turn into the A operand
// of the second products (O += P V; dV += P^T dO, dK += dS^T Q, dQ += dS K)
// in registers, never through shared memory.  P and dS enter those
// products as a hi + lo pair of bf16 values (hi = bf16(x), lo = bf16(x -
// hi)), two mma each, so they keep ~16 mantissa bits: rounded once to bf16
// they would put o, dq, dk and dv far over the bf16 check's limit (6-13x at
// the reduced shapes of tests/test_torch_flash_rounding.py, which pins
// this).  The split costs 6 pairs*hd FLOPs in the forward, 8 in dq and 12
// in dk/dv, against the function's 4, 6 and 8.  The streamed tiles (K, V in
// the forward and dq; Q, dO and their lse and delta in dk/dv) go through a
// two-stage cp.async ring, the next tile loading while this one computes;
// rows at or past Sq (Skv) are zero-filled by the copy.  The forward updates its
// online softmax once per 64-row kv tile (32 at hd 256), with the row max
// over the 4 lanes of a quad.  dk/dv has one CTA per (kv tile, query head,
// batch): with more than one query head per kv head it writes float32
// partials per query head, which the wrapper sums over the group.  No
// kernel uses atomics: each output is bitwise the same from run to run.
// What holds the tensor-core kernels above their bounds (mma.sync issue,
// the ldmatrix reads, the exp of every score, few warps per SM at hd 256)
// is not measured apart (PERF.md); wgmma fed by TMA is the next step.
//
// delta reads 16 bytes a lane, a row over hd * size / 16 lanes, in many
// small CTAs: bound by the bytes it reads, it runs at about twice that
// bound with L2 cold, the kernel's launch and the memory's ramp included.
//
// Seven kernels:
//   flash_fwd       (float32) one CTA per (q tile, head, batch); the kv loop
//                   runs inside the CTA (the TPU's sequential grid axis);
//                   running max, sum and accumulator in f32; writes o and the
//                   row logsumexp.
//   flash_fwd_mma   (bfloat16) the same, one CTA per (q tile, head, batch),
//                   heaviest causal q tiles first.
//   flash_bwd_delta delta = rowsum(dO * O), one CTA per run of rows
//                   (b, s, h).
//   flash_bwd_dkdv  (float32) one CTA per (kv tile, kv head, batch); loops
//                   over the G query heads of its group and the q tiles the
//                   mask allows, so dk/dv of a GQA group are reduced with no
//                   atomics.
//   flash_bwd_dq    (float32) one CTA per (q tile, head, batch), looping over
//                   kv tiles.
//   flash_bwd_dkdv_mma (bfloat16) one CTA per (kv tile, query head, batch),
//                   heaviest causal kv tiles first.
//   flash_bwd_dq_mma   (bfloat16) one CTA per (q tile, head, batch),
//                   heaviest causal q tiles first.
//
// Every entry point launches on the stream it is given and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;  // 16 x 16 thread grid

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

// rows [row0, row0 + ROWS) of one head into dst[r * LD + d], multiplied by
// `mul`; rows at or past S are zero.
template <int ROWS, int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int S,
                                          int row_stride, float mul) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += THREADS) {
    int r = idx / HD, d = idx - r * HD;
    int pos = row0 + r;
    dst[r * LD + d] = pos < S ? src[(size_t)pos * row_stride + d] * mul : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int Skv, int causal,
                                        int window) {
  return qpos < Sq && kpos < Skv && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// kv tiles (of C rows, of Skv) that q rows [q0, q0 + R) can see.
__device__ __forceinline__ void kv_range(int q0, int R, int C, int Skv, int causal, int window,
                                         int* lo, int* hi) {
  int last = (Skv + C - 1) / C - 1;
  if (causal) last = min(last, (q0 + R - 1) / C);
  int first = 0;
  if (window > 0) first = max(0, q0 - window + 1) / C;
  *lo = first;
  *hi = last;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
template <int HD, int R, int C>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Skv, int H, int KH, int causal, int window, float scale) {
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
  const float* qb = q + ((size_t)b * Sq * H + h) * HD;
  const float* kb = k + ((size_t)b * Skv * KH + kh) * HD;
  const float* vb = v + ((size_t)b * Skv * KH + kh) * HD;

  load_tile<R, HD>(Qs, qb, q0, Sq, qstride, scale);

  float acc[RM][DN], m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  int lo, hi;
  kv_range(q0, R, C, Skv, causal, window, &lo, &hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * C;
    __syncthreads();
    load_tile<C, HD>(Ks, kb, k0, Skv, kstride, 1.f);
    load_tile<C, HD>(Vs, vb, k0, Skv, kstride, 1.f);
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
        if (!visible(qpos, k0 + tx + 16 * j, Sq, Skv, causal, window)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = visible(qpos, k0 + tx + 16 * j, Sq, Skv, causal, window)
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
    if (qpos >= Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    float* ob = o + (((size_t)b * Sq + qpos) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < DN; ++j) ob[tx + 16 * j] = acc[i][j] / lc;
    if (tx == 0) lse[((size_t)b * H + h) * Sq + qpos] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// backward: delta = rowsum(dO * O)
// ---------------------------------------------------------------------------
// acc + the sum of the products of a 16-byte chunk of dO (8 bf16 or 4
// float32 values) and the same values of the float32 O: RO 16-byte chunks
// of O (RO = 2 beside a bf16 dO, else 1).
template <typename TD, int RO>
__device__ __forceinline__ float dot16(const uint4 (&a)[RO], const uint4& b, float acc) {
  if constexpr (std::is_same<TD, float>::value) {
    const float* x = reinterpret_cast<const float*>(&a[0]);
    const float* y = reinterpret_cast<const float*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc = fmaf(x[i], y[i], acc);
  } else {
    const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 xf = reinterpret_cast<const float2*>(&a[i / 2])[i % 2];
      const float2 yf = __bfloat1622float2(y[i]);
      acc = fmaf(xf.x, yf.x, acc);
      acc = fmaf(xf.y, yf.y, acc);
    }
  }
  return acc;
}

// A row (b, s, h) is read by L lanes, 16 bytes of dO a lane (CPL chunks a
// lane where 32 lanes do not cover it; RO chunks of O beside each), a CTA
// taking DELTA_THREADS / L consecutive rows; its sum is a shuffle over the
// L lanes, written by the first.  One row a thread group and many small
// CTAs measured faster with L2 cold than several rows a thread in flight or
// a CTA's writes staged into contiguous runs (PERF.md).  O is float32 for
// either dO: beside a bf16 dO it is the tensor-core forward's output before
// its rounding to bf16 (o32), so that delta = rowsum(dO * O) is not off by
// O's rounding, which in the short causal rows put dq off the float32
// reference's by up to ~1e-2 (PERF.md).
constexpr int DELTA_THREADS = 256;
template <typename TD, int HD>
__global__ void __launch_bounds__(DELTA_THREADS)
flash_bwd_delta_kernel(const float* __restrict__ o, const TD* __restrict__ dout,
                       float* __restrict__ delta, int S, int H, int rows) {
  constexpr int CPR = HD * sizeof(TD) / 16;  // 16-byte chunks of a dO row
  constexpr int RO = sizeof(float) / sizeof(TD);
  constexpr int L = CPR < 32 ? CPR : 32, CPL = CPR / L;
  const int r = blockIdx.x * (DELTA_THREADS / L) + threadIdx.x / L, li = threadIdx.x % L;
  const uint4* ob = reinterpret_cast<const uint4*>(o) + ((size_t)r * CPR + li) * RO;
  const uint4* db = reinterpret_cast<const uint4*>(dout) + (size_t)r * CPR + li;
  uint4 x[CPL][RO], y[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    if (r < rows) {
#pragma unroll
      for (int i = 0; i < RO; ++i) x[c][i] = __ldg(ob + c * L * RO + i);
      y[c] = __ldg(db + c * L);
    } else {
#pragma unroll
      for (int i = 0; i < RO; ++i) x[c][i] = make_uint4(0u, 0u, 0u, 0u);
      y[c] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc = dot16<TD, RO>(x[c], y[c], acc);
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (li == 0 && r < rows) {
    const int h = r % H, bs = r / H, s = bs % S, b = bs / S;
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// backward: dq.  P = exp(s - lse), dS = P * (dO.V - delta), dq = scale * dS K.
// ---------------------------------------------------------------------------
template <int HD, int R, int C>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int Sq, int Skv, int H, int KH, int causal,
                    int window, float scale) {
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
  const size_t head_off = ((size_t)b * Sq * H + h) * HD;
  const float* kb = k + ((size_t)b * Skv * KH + kh) * HD;
  const float* vb = v + ((size_t)b * Skv * KH + kh) * HD;
  const float* lseb = lse + ((size_t)b * H + h) * Sq;
  const float* deltab = delta + ((size_t)b * H + h) * Sq;

  load_tile<R, HD>(Qs, q + head_off, q0, Sq, qstride, scale);
  load_tile<R, HD>(dOs, dout + head_off, q0, Sq, qstride, 1.f);

  float lse_r[RM], delta_r[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qpos = q0 + ty * RM + i;
    lse_r[i] = qpos < Sq ? lseb[qpos] : 0.f;
    delta_r[i] = qpos < Sq ? deltab[qpos] : 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  int lo, hi;
  kv_range(q0, R, C, Skv, causal, window, &lo, &hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * C;
    __syncthreads();
    load_tile<C, HD>(Ks, kb, k0, Skv, kstride, 1.f);
    load_tile<C, HD>(Vs, vb, k0, Skv, kstride, 1.f);
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
        const float p = visible(qpos, k0 + tx + 16 * j, Sq, Skv, causal, window)
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
    if (qpos >= Sq) continue;
    float* db = dq + (((size_t)b * Sq + qpos) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < DN; ++j) db[tx + 16 * j] = acc[i][j] * scale;
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv.  Works on the transposed tiles (kv rows x q columns):
// dv = P^T dO, dk = dS^T (scale * q), summed over the G heads of the group.
// ---------------------------------------------------------------------------
template <int HD, int R, int C>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv, int H,
                      int KH, int causal, int window, float scale) {
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
  const size_t kv_off = ((size_t)b * Skv * KH + kh) * HD;

  load_tile<R, HD>(Ks, k + kv_off, k0, Skv, kstride, 1.f);
  load_tile<R, HD>(Vs, v + kv_off, k0, Skv, kstride, 1.f);

  float dk_acc[RM][DN], dv_acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nqt = (Sq + C - 1) / C;
  const int qt_lo = causal ? k0 / C : 0;
  const int qt_hi = window > 0 ? min(nqt - 1, (k0 + R + window - 2) / C) : nqt - 1;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t head_off = ((size_t)b * Sq * H + h) * HD;
    const float* lseb = lse + ((size_t)b * H + h) * Sq;
    const float* deltab = delta + ((size_t)b * H + h) * Sq;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * C;
      __syncthreads();
      load_tile<C, HD>(Qs, q + head_off, q0, Sq, qstride, scale);
      load_tile<C, HD>(dOs, dout + head_off, q0, Sq, qstride, 1.f);
      float lse_c[CN], delta_c[CN];
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int qpos = q0 + tx + 16 * j;
        lse_c[j] = qpos < Sq ? lseb[qpos] : 0.f;
        delta_c[j] = qpos < Sq ? deltab[qpos] : 0.f;
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
          const float p = visible(q0 + tx + 16 * j, kpos, Sq, Skv, causal, window)
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
    if (kpos >= Skv) continue;
    const size_t off = (((size_t)b * Skv + kpos) * KH + kh) * HD;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      dk[off + tx + 16 * j] = dk_acc[i][j];
      dv[off + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: the forward, dk/dv and dq
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8 x 8 bf16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8 and receives, of each, row lane / 4, columns 2 (lane % 4)
// and +1 (with .trans: of the transposed matrix).
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col).
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) as hi + lo, both packed bf16 pairs: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// The A operand (hi and lo) of a 16 x 16 block held as two m16n8
// accumulators t0 (columns 0-7) and t1 (columns 8-15): the accumulator's
// (row, column pair) layout is the A fragment's.
__device__ __forceinline__ void to_a_frag(const float (&t0)[4], const float (&t1)[4],
                                          uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_pair(t0[0], t0[1], hi[0], lo[0]);
  split_pair(t0[2], t0[3], hi[1], lo[1]);
  split_pair(t1[0], t1[1], hi[2], lo[2]);
  split_pair(t1[2], t1[3], hi[3], lo[3]);
}

// cp.async of 16 (or 4) bytes; src_bytes 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of one head (row stride `stride` elements) into
// dst[r * (HD + 8) + d], asynchronously; rows at or past S (the tensor's
// length: Sq or Skv) are zeros.
template <int ROWS, int HD, int NT>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int row0, int S,
                                                int stride) {
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += NT) {
    const int r = idx / CPR, c = idx - r * CPR, pos = row0 + r;
    cp_async16(dst + r * (HD + 8) + c * 8, src + (size_t)(pos < S ? pos : 0) * stride + c * 8,
               pos < S ? 16 : 0);
  }
}
template <int ROWS, int NT>
__device__ __forceinline__ void load_stats_async(float* dst, const float* src, int row0, int S) {
  for (int r = threadIdx.x; r < ROWS; r += NT) {
    const int pos = row0 + r;
    cp_async4(dst + r, src + (pos < S ? pos : 0), pos < S ? 4 : 0);
  }
}

// The forward for bfloat16.  CTA: BR = 16 NW q rows of one query head; warp
// w owns q rows 16w..16w+15 and, per kv tile of BC rows, builds S = Q K^T
// (16 x BC f32), updates its online softmax once for the tile, and feeds P
// (hi + lo) as A to O += P V.  A row's BC scores lie in the 4 lanes of a
// quad (columns 2t, 2t + 1 of each n8 block), so its max is two shuffles;
// its sum stays a per-lane partial until the epilogue.  Scores are kept as
// s * scale * log2(e), so P = exp2(s' - m').  With o32 (not null) it also
// writes the output in float32, before its rounding: what the backward's
// delta reads.
template <int HD, int NW, int BC>
__global__ void __launch_bounds__(NW * 32, 1)  // up to 255 registers: no spills
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     float* __restrict__ o32, int Sq, int Skv, int H, int KH, int causal,
                     int window, float scale) {
  constexpr int NT = NW * 32, BR = 16 * NW, LDS = HD + 8, NC = BC / 16;
  constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BR * LDS;        // two stages of BC x LDS
  bf16* Vs = Ks + 2 * BC * LDS;    // two stages

  const int nqt = (Sq + BR - 1) / BR;
  const int q0 = (nqt - 1 - blockIdx.y) * BR;  // y = 0 first: the last q tile sees the most kv tiles
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int qstride = H * HD, kstride = KH * HD;
  const size_t q_off = ((size_t)b * Sq * H + h) * HD, kv_off = ((size_t)b * Skv * KH + kh) * HD;

  int lo, hi;
  kv_range(q0, BR, BC, Skv, causal, window, &lo, &hi);
  auto load_kv = [&](int kt, int st) {
    load_tile_async<BC, HD, NT>(Ks + st * BC * LDS, k + kv_off, kt * BC, Skv, kstride);
    load_tile_async<BC, HD, NT>(Vs + st * BC * LDS, v + kv_off, kt * BC, Skv, kstride);
  };
  load_tile_async<BR, HD, NT>(Qs, q + q_off, q0, Sq, qstride);
  load_kv(lo, 0);
  cp_async_commit();

  const int qw0 = q0 + warp * 16;  // this warp's first q row
  const float sl2 = scale * LOG2E;
  // rows g and g + 8: running max of s', this lane's part of the running sum
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
  const uint32_t q_addr = smem_u32(Qs + (warp * 16 + a_row) * LDS + a_col);

  for (int kt = lo; kt <= hi; ++kt) {
    const int st = (kt - lo) & 1;
    if (kt < hi) load_kv(kt + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + st * BC * LDS;
    const bf16* Vt = Vs + st * BC * LDS;
    const int k0 = kt * BC;
    // the 16-column blocks of which this warp sees something (warp-uniform)
    unsigned vis = 0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int kc0 = k0 + c * 16;
      if (!(qw0 >= Sq || kc0 >= Skv || (causal && kc0 > qw0 + 15) ||
            (window > 0 && qw0 - (kc0 + 15) >= window)))
        vis |= 1u << c;
    }
    if (vis) {
      float s[NC][2][4];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[c][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(q_addr + kk * 32, a);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (!((vis >> c) & 1)) continue;
          uint32_t bb[4];
          ldsm_x4(smem_u32(Kt + (c * 16 + b_row) * LDS + b_col) + kk * 32, bb);
          mma16816(s[c][0], a, bb[0], bb[1]);
          mma16816(s[c][1], a, bb[2], bb[3]);
        }
      }
      // entry e of n8 block j of block c: q row g (+8 for e >= 2), kv column
      // c * 16 + j * 8 + 2t (+1 for odd e)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (!((vis >> c) & 1)) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const bool ok = visible(qw0 + g + r * 8, k0 + c * 16 + j * 8 + 2 * t + (e & 1), Sq,
                                    Skv, causal, window);
            s[c][j][e] = ok ? s[c][j][e] * sl2 : NEG_INF;
            mx[r] = fmaxf(mx[r], s[c][j][e]);
          }
      }
      float corr[2], mu[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f(m[r] - mx[r]);  // 1 while the row has seen nothing, 0 from NEG_INF
        m[r] = mx[r];
        mu[r] = mx[r] == NEG_INF ? 0.f : mx[r];  // masked entries then give exp2(NEG_INF) = 0
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (!((vis >> c) & 1)) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            s[c][j][e] = exp2f(s[c][j][e] - mu[r]);
            l[r] += s[c][j][e];
          }
        uint32_t ph[4], pl[4];
        to_a_frag(s[c][0], s[c][1], ph, pl);
        const uint32_t vt_addr = smem_u32(Vt + (c * 16 + a_row) * LDS + a_col);
#pragma unroll
        for (int n = 0; n < HD / 16; ++n) {
          uint32_t bb[4];
          ldsm_x4_t(vt_addr + n * 32, bb);
          mma16816(acc[2 * n], ph, bb[0], bb[1]);
          mma16816(acc[2 * n], pl, bb[0], bb[1]);
          mma16816(acc[2 * n + 1], ph, bb[2], bb[3]);
          mma16816(acc[2 * n + 1], pl, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // the next iteration loads into this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = qw0 + g + half * 8;
    if (qpos >= Sq) continue;
    const size_t off = (((size_t)b * Sq + qpos) * H + h) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const float2 x = make_float2(acc[n][2 * half] / l[half], acc[n][2 * half + 1] / l[half]);
      *reinterpret_cast<__nv_bfloat162*>(o + off + n * 8) = __float22bfloat162_rn(x);
      if (o32) *reinterpret_cast<float2*>(o32 + off + n * 8) = x;
    }
    if (t == 0) lse[((size_t)b * H + h) * Sq + qpos] = m[half] * LN2 + logf(l[half]);
  }
}

// dk, dv for bfloat16.  CTA: BC = 16 NW kv rows of one query head h, in
// HD / DV groups of NW warps, group c owning output columns [c DV, c DV +
// DV) (DV < HD: each group recomputes the scores, from the same shared
// tiles).  Warp w of a group owns kv rows 16w..16w+15 and, per 16-row q
// chunk, builds S^T = K Q^T and dP^T = V dO^T (16 x 16 f32), then P^T, dS^T
// and feeds them as A to dV += P^T dO and dK += dS^T Q.  G = 1: writes dk,
// dv in bf16 (B, Skv, KH, HD); G > 1: float32 partials per query head
// (B, Skv, H, HD).
template <int HD, int DV, int NW, int BR>
__global__ void __launch_bounds__(NW * 32 * (HD / DV), 1)  // up to 255 registers: no spills
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          void* __restrict__ dk, void* __restrict__ dv, int Sq, int Skv, int H,
                          int KH, int causal, int window, float scale) {
  constexpr int NT = NW * 32 * (HD / DV), BC = 16 * NW, LDS = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BC * LDS;
  bf16* Qs = Vs + BC * LDS;        // two stages of BR x LDS
  bf16* dOs = Qs + 2 * BR * LDS;   // two stages
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BR * LDS);  // two stages of BR
  float* Ds = Ls + 2 * BR;

  const int k0 = blockIdx.y * BC;  // y = 0 first: the lowest kv tile sees the most q tiles
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int G = H / KH, kh = h / G;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = (threadIdx.x >> 5) % NW, dv0 = (threadIdx.x >> 5) / NW * DV;
  const int qstride = H * HD, kstride = KH * HD;
  const size_t kv_off = ((size_t)b * Skv * KH + kh) * HD, q_off = ((size_t)b * Sq * H + h) * HD;
  const float* lseb = lse + ((size_t)b * H + h) * Sq;
  const float* deltab = delta + ((size_t)b * H + h) * Sq;

  const int nqt = (Sq + BR - 1) / BR;
  const int qt_lo = causal ? k0 / BR : 0;
  const int qt_hi = window > 0 ? min(nqt - 1, (k0 + BC + window - 2) / BR) : nqt - 1;

  auto load_q = [&](int qt, int st) {
    load_tile_async<BR, HD, NT>(Qs + st * BR * LDS, q + q_off, qt * BR, Sq, qstride);
    load_tile_async<BR, HD, NT>(dOs + st * BR * LDS, dout + q_off, qt * BR, Sq, qstride);
    load_stats_async<BR, NT>(Ls + st * BR, lseb, qt * BR, Sq);
    load_stats_async<BR, NT>(Ds + st * BR, deltab, qt * BR, Sq);
  };
  load_tile_async<BC, HD, NT>(Ks, k + kv_off, k0, Skv, kstride);
  load_tile_async<BC, HD, NT>(Vs, v + kv_off, k0, Skv, kstride);
  load_q(qt_lo, 0);
  cp_async_commit();

  float dk_acc[DV / 8][4], dv_acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  // lane parts of the ldmatrix addresses: A and .trans B (row-major 16 x 16
  // blocks), and B read from an N x K row-major tile (two n8 blocks)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
  const int kw0 = k0 + warp * 16;  // this warp's first kv row
  const uint32_t k_addr = smem_u32(Ks + (warp * 16 + a_row) * LDS + a_col);
  const uint32_t v_addr = smem_u32(Vs + (warp * 16 + a_row) * LDS + a_col);

  for (int qt = qt_lo; qt <= qt_hi; ++qt) {
    const int st = (qt - qt_lo) & 1;
    if (qt < qt_hi) load_q(qt + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qt = Qs + st * BR * LDS;
    const bf16* dOt = dOs + st * BR * LDS;
    const float* Lt = Ls + st * BR;
    const float* Dt = Ds + st * BR;
    const int q0 = qt * BR;
#pragma unroll 1
    for (int c = 0; c < BR / 16; ++c) {
      const int qc0 = q0 + c * 16;
      if (kw0 >= Skv || qc0 >= Sq || (causal && qc0 + 15 < kw0) ||
          (window > 0 && qc0 - (kw0 + 15) >= window))
        continue;  // nothing of this 16 x 16 block is visible (warp-uniform)
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      const uint32_t qb_addr = smem_u32(Qt + (c * 16 + b_row) * LDS + b_col);
      const uint32_t ob_addr = smem_u32(dOt + (c * 16 + b_row) * LDS + b_col);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4], bb[4];
        ldsm_x4(k_addr + kk * 32, a);
        ldsm_x4(qb_addr + kk * 32, bb);
        mma16816(s[0], a, bb[0], bb[1]);
        mma16816(s[1], a, bb[2], bb[3]);
        ldsm_x4(v_addr + kk * 32, a);
        ldsm_x4(ob_addr + kk * 32, bb);
        mma16816(dp[0], a, bb[0], bb[1]);
        mma16816(dp[1], a, bb[2], bb[3]);
      }
      // accumulator entry e of n8 block j: kv row g (+8 for e >= 2), q
      // column j * 8 + 2t (+1 for odd e)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = c * 16 + j * 8 + 2 * t + (e & 1);
          const float p = visible(q0 + ql, kw0 + g + (e >> 1) * 8, Sq, Skv, causal, window)
                              ? expf(s[j][e] * scale - Lt[ql]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - Dt[ql]);
        }
      uint32_t ph[4], pl[4], dh[4], dl[4];
      to_a_frag(s[0], s[1], ph, pl);
      to_a_frag(dp[0], dp[1], dh, dl);
      const uint32_t ot_addr = smem_u32(dOt + (c * 16 + a_row) * LDS + dv0 + a_col);
      const uint32_t qt_addr = smem_u32(Qt + (c * 16 + a_row) * LDS + dv0 + a_col);
#pragma unroll
      for (int n = 0; n < DV / 16; ++n) {
        uint32_t bb[4];
        ldsm_x4_t(ot_addr + n * 32, bb);
        mma16816(dv_acc[2 * n], ph, bb[0], bb[1]);
        mma16816(dv_acc[2 * n], pl, bb[0], bb[1]);
        mma16816(dv_acc[2 * n + 1], ph, bb[2], bb[3]);
        mma16816(dv_acc[2 * n + 1], pl, bb[2], bb[3]);
        ldsm_x4_t(qt_addr + n * 32, bb);
        mma16816(dk_acc[2 * n], dh, bb[0], bb[1]);
        mma16816(dk_acc[2 * n], dl, bb[0], bb[1]);
        mma16816(dk_acc[2 * n + 1], dh, bb[2], bb[3]);
        mma16816(dk_acc[2 * n + 1], dl, bb[2], bb[3]);
      }
    }
    __syncthreads();  // the next iteration loads into this stage
  }
  cp_async_wait<0>();

  const bool partial = G > 1;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kpos = kw0 + g + half * 8;
      if (kpos >= Skv) continue;
      const int col = dv0 + n * 8 + 2 * t;
      const float2 kx = make_float2(dk_acc[n][2 * half] * scale, dk_acc[n][2 * half + 1] * scale);
      const float2 vx = make_float2(dv_acc[n][2 * half], dv_acc[n][2 * half + 1]);
      if (partial) {
        const size_t off = (((size_t)b * Skv + kpos) * H + h) * HD + col;
        *reinterpret_cast<float2*>(static_cast<float*>(dk) + off) = kx;
        *reinterpret_cast<float2*>(static_cast<float*>(dv) + off) = vx;
      } else {
        const size_t off = (((size_t)b * Skv + kpos) * KH + kh) * HD + col;
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(dk) + off) = __float22bfloat162_rn(kx);
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(dv) + off) = __float22bfloat162_rn(vx);
      }
    }
}

// dq for bfloat16.  CTA: BR = 16 NW q rows of one head; warp w owns q rows
// 16w..16w+15 and, per 16-row kv chunk, builds S = Q K^T and dP = dO V^T
// (16 x 16 f32), then dS, and feeds it as A to dQ += dS K.
template <int HD, int NW, int BC>
__global__ void __launch_bounds__(NW * 32, 1)  // up to 255 registers: no spills
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int Sq, int Skv, int H, int KH, int causal,
                        int window, float scale) {
  constexpr int NT = NW * 32, BR = 16 * NW, LDS = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BR * LDS;
  bf16* Ks = dOs + BR * LDS;       // two stages of BC x LDS
  bf16* Vs = Ks + 2 * BC * LDS;    // two stages

  const int nqt = (Sq + BR - 1) / BR;
  const int q0 = (nqt - 1 - blockIdx.y) * BR;  // y = 0 first: the last q tile sees the most kv tiles
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int qstride = H * HD, kstride = KH * HD;
  const size_t q_off = ((size_t)b * Sq * H + h) * HD, kv_off = ((size_t)b * Skv * KH + kh) * HD;

  int lo, hi;
  kv_range(q0, BR, BC, Skv, causal, window, &lo, &hi);
  auto load_kv = [&](int kt, int st) {
    load_tile_async<BC, HD, NT>(Ks + st * BC * LDS, k + kv_off, kt * BC, Skv, kstride);
    load_tile_async<BC, HD, NT>(Vs + st * BC * LDS, v + kv_off, kt * BC, Skv, kstride);
  };
  load_tile_async<BR, HD, NT>(Qs, q + q_off, q0, Sq, qstride);
  load_tile_async<BR, HD, NT>(dOs, dout + q_off, q0, Sq, qstride);
  load_kv(lo, 0);
  cp_async_commit();

  const int qw0 = q0 + warp * 16;  // this warp's first q row
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = qw0 + g + half * 8;
    lse_r[half] = qpos < Sq ? lse[((size_t)b * H + h) * Sq + qpos] : 0.f;
    delta_r[half] = qpos < Sq ? delta[((size_t)b * H + h) * Sq + qpos] : 0.f;
  }
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
  const uint32_t q_addr = smem_u32(Qs + (warp * 16 + a_row) * LDS + a_col);
  const uint32_t o_addr = smem_u32(dOs + (warp * 16 + a_row) * LDS + a_col);

  for (int kt = lo; kt <= hi; ++kt) {
    const int st = (kt - lo) & 1;
    if (kt < hi) load_kv(kt + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + st * BC * LDS;
    const bf16* Vt = Vs + st * BC * LDS;
    const int k0 = kt * BC;
#pragma unroll 1
    for (int c = 0; c < BC / 16; ++c) {
      const int kc0 = k0 + c * 16;
      if (qw0 >= Sq || kc0 >= Skv || (causal && kc0 > qw0 + 15) ||
          (window > 0 && qw0 - (kc0 + 15) >= window))
        continue;  // nothing of this 16 x 16 block is visible (warp-uniform)
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      const uint32_t kb_addr = smem_u32(Kt + (c * 16 + b_row) * LDS + b_col);
      const uint32_t vb_addr = smem_u32(Vt + (c * 16 + b_row) * LDS + b_col);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4], bb[4];
        ldsm_x4(q_addr + kk * 32, a);
        ldsm_x4(kb_addr + kk * 32, bb);
        mma16816(s[0], a, bb[0], bb[1]);
        mma16816(s[1], a, bb[2], bb[3]);
        ldsm_x4(o_addr + kk * 32, a);
        ldsm_x4(vb_addr + kk * 32, bb);
        mma16816(dp[0], a, bb[0], bb[1]);
        mma16816(dp[1], a, bb[2], bb[3]);
      }
      // accumulator entry e of n8 block j: q row g (+8 for e >= 2), kv
      // column j * 8 + 2t (+1 for odd e)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = visible(qw0 + g + r * 8, kc0 + j * 8 + 2 * t + (e & 1), Sq, Skv,
                                  causal, window)
                              ? expf(s[j][e] * scale - lse_r[r]) : 0.f;
          dp[j][e] = p * (dp[j][e] - delta_r[r]);
        }
      uint32_t dh[4], dl[4];
      to_a_frag(dp[0], dp[1], dh, dl);
      const uint32_t kt_addr = smem_u32(Kt + (c * 16 + a_row) * LDS + a_col);
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        uint32_t bb[4];
        ldsm_x4_t(kt_addr + n * 32, bb);
        mma16816(acc[2 * n], dh, bb[0], bb[1]);
        mma16816(acc[2 * n], dl, bb[0], bb[1]);
        mma16816(acc[2 * n + 1], dh, bb[2], bb[3]);
        mma16816(acc[2 * n + 1], dl, bb[2], bb[3]);
      }
    }
    __syncthreads();  // the next iteration loads into this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qpos = qw0 + g + half * 8;
      if (qpos >= Sq) continue;
      bf16* db = dq + (((size_t)b * Sq + qpos) * H + h) * HD + n * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(db) = __float22bfloat162_rn(
          make_float2(acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale));
    }
}

// ---------------------------------------------------------------------------
// host side: tile sizes per head dim, dispatch on (dtype, hd)
// ---------------------------------------------------------------------------
// FMA kernels (the forward, and the float32 backward): R rows per CTA and C
// rows per inner tile: 64 x 64 up to hd 128; 32 x 32 at hd 256, where the
// four float32 tiles of the backward would not fit in the 227 KB a block
// may hold.
template <int HD> struct Tiles { static constexpr int R = 64, C = 64; };
template <> struct Tiles<256> { static constexpr int R = 32, C = 32; };

// Tensor-core backward (bfloat16): NW warps of 16 rows each own the CTA's
// 16 NW rows (kv rows in dk/dv, q rows in dq); STREAM rows of the other
// side per ring stage; DV dk/dv columns per warp.  A warp's dK and dV
// accumulators are 16 x DV f32 each, DV registers a thread for the pair:
// at hd 256 (256 registers) they would not fit, so there DV = 128 and the
// CTA runs two groups of NW warps, one per column half, sharing the tiles
// and each recomputing S and dP (16 pairs*hd FLOPs in all against 12).  dq
// keeps 16 x hd f32, hd / 2 registers a thread (the same split there was
// slower: PERF.md).  Shared memory, bf16 rows padded to hd + 8: dk/dv
// (2 * 16 NW + 4 STREAM) rows + 16 STREAM bytes of lse/delta, dq (2 * 16 NW
// + 4 STREAM) rows; 105 KB at hd 128 (two CTAs per SM) and 203 KB at hd
// 256 (one).
template <int HD> struct MmaTiles {
  static constexpr int NW = 4, STREAM = 64, DV = HD < 128 ? HD : 128;
};

// Tensor-core forward (bfloat16): NW warps of 16 q rows each, BC kv rows
// per ring stage.  A warp's O accumulator is 16 x hd f32, hd / 2 registers a
// thread, and its scores BC / 2 more.  Shared memory (16 NW + 4 BC) rows of
// hd + 8 bf16: 85 KB at hd 128 (two CTAs per SM); at hd 256 a 32-row stream
// keeps it at 99 KB, two CTAs per SM (a 64-row one would take 165 KB, one).
template <int HD> struct FwdTiles { static constexpr int NW = 4, BC = HD < 256 ? 64 : 32; };

template <int HD> constexpr size_t fwd_mma_smem() {
  return sizeof(bf16) * (16 * FwdTiles<HD>::NW + 4 * FwdTiles<HD>::BC) * (HD + 8);
}
template <int HD> constexpr size_t dkdv_mma_smem() {
  using M = MmaTiles<HD>;
  return sizeof(bf16) * (2 * 16 * M::NW + 4 * M::STREAM) * (HD + 8) +
         sizeof(float) * 4 * M::STREAM;
}
template <int HD> constexpr size_t dq_mma_smem() {
  using M = MmaTiles<HD>;
  return sizeof(bf16) * (2 * 16 * M::NW + 4 * M::STREAM) * (HD + 8);
}

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
  float *lse, *delta, *o32;
  int B, Sq, Skv, H, KH, causal, window;
  float scale;
  cudaStream_t stream;
};

template <int HD> cudaError_t launch_fwd(const Args& a) {
  constexpr int R = Tiles<HD>::R, C = Tiles<HD>::C;
  auto kern = flash_fwd_kernel<HD, R, C>;
  constexpr size_t smem = fwd_smem<HD>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.Sq + R - 1) / R, a.H, a.B);
  kern<<<grid, THREADS, smem, a.stream>>>((const float*)a.q, (const float*)a.k, (const float*)a.v,
                                          (float*)a.o, a.lse, a.Sq, a.Skv, a.H, a.KH, a.causal,
                                          a.window, a.scale);
  return cudaGetLastError();
}

template <int HD> cudaError_t launch_fwd_mma(const Args& a) {
  using F = FwdTiles<HD>;
  auto kern = flash_fwd_mma_kernel<HD, F::NW, F::BC>;
  constexpr size_t smem = fwd_mma_smem<HD>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  constexpr int BR = 16 * F::NW;
  dim3 grid(a.B * a.H, (a.Sq + BR - 1) / BR);
  kern<<<grid, 32 * F::NW, smem, a.stream>>>((const bf16*)a.q, (const bf16*)a.k,
                                             (const bf16*)a.v, (bf16*)a.o, a.lse, a.o32, a.Sq,
                                             a.Skv, a.H, a.KH, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int HD> cudaError_t launch_dq_mma(const Args& a) {
  using M = MmaTiles<HD>;
  auto kern = flash_bwd_dq_mma_kernel<HD, M::NW, M::STREAM>;
  constexpr size_t smem = dq_mma_smem<HD>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  constexpr int BR = 16 * M::NW;
  dim3 grid(a.B * a.H, (a.Sq + BR - 1) / BR);
  kern<<<grid, 32 * M::NW, smem, a.stream>>>((const bf16*)a.q, (const bf16*)a.k,
                                             (const bf16*)a.v, (const bf16*)a.dout, a.lse,
                                             a.delta, (bf16*)a.dq, a.Sq, a.Skv, a.H, a.KH,
                                             a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// dk, dv: bf16 (B, Skv, KH, HD) where H == KH, else float32 partials
// (B, Skv, H, HD) that the caller sums over each group of H / KH heads.
template <int HD> cudaError_t launch_dkdv_mma(const Args& a) {
  using M = MmaTiles<HD>;
  auto kern = flash_bwd_dkdv_mma_kernel<HD, M::DV, M::NW, M::STREAM>;
  constexpr size_t smem = dkdv_mma_smem<HD>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  constexpr int BC = 16 * M::NW;
  dim3 grid(a.B * a.H, (a.Skv + BC - 1) / BC);
  kern<<<grid, 32 * M::NW * (HD / M::DV), smem, a.stream>>>((const bf16*)a.q, (const bf16*)a.k,
                                             (const bf16*)a.v, (const bf16*)a.dout, a.lse,
                                             a.delta, a.dk, a.dv, a.Sq, a.Skv, a.H, a.KH,
                                             a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// out = {registers a thread, dynamic shared bytes, threads, CTAs per SM}
template <typename K>
cudaError_t occupancy(K kern, size_t smem, int threads, int* out) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kern);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kern, threads, smem);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = (int)smem;
  out[2] = threads;
  return cudaSuccess;
}
// which: 0 the forward, 1 dq, 2 dk/dv
template <int HD> cudaError_t mma_occupancy(int which, int* out) {
  using F = FwdTiles<HD>;
  using M = MmaTiles<HD>;
  if (which == 0)
    return occupancy(flash_fwd_mma_kernel<HD, F::NW, F::BC>, fwd_mma_smem<HD>(), 32 * F::NW,
                     out);
  if (which == 1)
    return occupancy(flash_bwd_dq_mma_kernel<HD, M::NW, M::STREAM>, dq_mma_smem<HD>(),
                     32 * M::NW, out);
  if (which == 2)
    return occupancy(flash_bwd_dkdv_mma_kernel<HD, M::DV, M::NW, M::STREAM>,
                     dkdv_mma_smem<HD>(), 32 * M::NW * (HD / M::DV), out);
  return cudaErrorInvalidValue;
}

template <int HD> cudaError_t launch_dq(const Args& a) {
  constexpr int R = Tiles<HD>::R, C = Tiles<HD>::C;
  auto kern = flash_bwd_dq_kernel<HD, R, C>;
  constexpr size_t smem = dq_smem<HD>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.Sq + R - 1) / R, a.H, a.B);
  kern<<<grid, THREADS, smem, a.stream>>>((const float*)a.q, (const float*)a.k, (const float*)a.v,
                                          (const float*)a.dout, a.lse, a.delta, (float*)a.dq, a.Sq,
                                          a.Skv, a.H, a.KH, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int HD> cudaError_t launch_dkdv(const Args& a) {
  constexpr int R = Tiles<HD>::R, C = Tiles<HD>::C;
  auto kern = flash_bwd_dkdv_kernel<HD, R, C>;
  constexpr size_t smem = dkdv_smem<HD>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.Skv + R - 1) / R, a.KH, a.B);
  kern<<<grid, THREADS, smem, a.stream>>>((const float*)a.q, (const float*)a.k, (const float*)a.v,
                                          (const float*)a.dout, a.lse, a.delta, (float*)a.dk,
                                          (float*)a.dv, a.Sq, a.Skv, a.H, a.KH, a.causal,
                                          a.window, a.scale);
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
// float32 on the FMA kernels, bfloat16 on the tensor cores.
template <typename T, int HD> struct Fwd {
  static cudaError_t run(const Args& a) {
    if constexpr (std::is_same<T, bf16>::value) return launch_fwd_mma<HD>(a);
    else return launch_fwd<HD>(a);
  }
};
template <typename T, int HD> struct Dq {
  static cudaError_t run(const Args& a) {
    if constexpr (std::is_same<T, bf16>::value) return launch_dq_mma<HD>(a);
    else return launch_dq<HD>(a);
  }
};
template <typename T, int HD> struct Dkdv {
  static cudaError_t run(const Args& a) {
    if constexpr (std::is_same<T, bf16>::value) return launch_dkdv_mma<HD>(a);
    else return launch_dkdv<HD>(a);
  }
};

template <typename TD, int HD>
cudaError_t launch_delta(const float* o, const void* dout, float* delta, int B, int S, int H,
                         cudaStream_t st) {
  constexpr int CPR = HD * sizeof(TD) / 16, ROWS = DELTA_THREADS / (CPR < 32 ? CPR : 32);
  const int rows = B * S * H;
  flash_bwd_delta_kernel<TD, HD><<<(rows + ROWS - 1) / ROWS, DELTA_THREADS, 0, st>>>(
      o, (const TD*)dout, delta, S, H, rows);
  return cudaGetLastError();
}
template <typename TD>
cudaError_t delta_by_hd(const float* o, const void* dout, float* delta, int B, int S, int H,
                        int hd, cudaStream_t st) {
  switch (hd) {
    case 32: return launch_delta<TD, 32>(o, dout, delta, B, S, H, st);
    case 64: return launch_delta<TD, 64>(o, dout, delta, B, S, H, st);
    case 128: return launch_delta<TD, 128>(o, dout, delta, B, S, H, st);
    case 256: return launch_delta<TD, 256>(o, dout, delta, B, S, H, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window <= 0 means no sliding window.  Sq
// and Skv are q's and k's lengths (equal unless causal and window are off).
// o32: null, or (bfloat16 only) a float32 (B, Sq, H, hd) that receives the
// output before its rounding to bfloat16.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         float* o32, int B, int Sq, int Skv, int H, int KH, int hd, int causal,
                         int window, float scale, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse; a.o32 = o32;
  a.B = B; a.Sq = Sq; a.Skv = Skv; a.H = H; a.KH = KH; a.causal = causal; a.window = window;
  a.scale = scale; a.stream = (cudaStream_t)stream;
  return (int)Dispatch<Fwd>::run(dtype, hd, a);
}

// o is float32 (for a bfloat16 dout, the forward's o32); dtype is dout's:
// 0 float32, 1 bfloat16.  o and dout start on a 16-byte boundary (the
// kernel reads 16-byte chunks).
extern "C" int flash_bwd_delta(const float* o, const void* dout, float* delta, int B, int S,
                               int H, int hd, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)delta_by_hd<float>(o, dout, delta, B, S, H, hd, st);
  if (dtype == 1) return (int)delta_by_hd<bf16>(o, dout, delta, B, S, H, hd, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq, int B, int Sq,
                            int Skv, int H, int KH, int hd, int causal, int window, float scale,
                            int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = (float*)lse; a.delta = (float*)delta;
  a.dq = dq; a.B = B; a.Sq = Sq; a.Skv = Skv; a.H = H; a.KH = KH; a.causal = causal;
  a.window = window;
  a.scale = scale; a.stream = (cudaStream_t)stream;
  return (int)Dispatch<Dq>::run(dtype, hd, a);
}

// bfloat16 with H > KH: dk and dv are float32 (B, Skv, H, hd) partials, one
// per query head, for the caller to sum over each group of H / KH heads.
extern "C" int flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, void* dk, void* dv, int B,
                              int Sq, int Skv, int H, int KH, int hd, int causal, int window,
                              float scale, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = (float*)lse; a.delta = (float*)delta;
  a.dk = dk; a.dv = dv; a.B = B; a.Sq = Sq; a.Skv = Skv; a.H = H; a.KH = KH; a.causal = causal;
  a.window = window; a.scale = scale; a.stream = (cudaStream_t)stream;
  return (int)Dispatch<Dkdv>::run(dtype, hd, a);
}

// The bfloat16 tensor-core kernels' resources at head dim hd (which: 0 the
// forward, 1 dq, 2 dk/dv): out = {registers a thread, dynamic shared bytes,
// threads, CTAs per SM}.
extern "C" int flash_mma_occupancy(int which, int hd, int* out) {
  switch (hd) {
    case 32: return (int)mma_occupancy<32>(which, out);
    case 64: return (int)mma_occupancy<64>(which, out);
    case 128: return (int)mma_occupancy<128>(which, out);
    case 256: return (int)mma_occupancy<256>(which, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
