// RG-LRU scan, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru.py::_rglru_kernel (the
// Pallas forward); the backward kernel has no TPU counterpart (its
// reference is jax.grad of repro.kernels.ref.rglru).
//
// Layout: x, r, i, out, dout, dx, dr, di (B, S, W) contiguous, float32 or
// bfloat16 (one dtype for all); lam (W,) float32; h0, h_last, dh_last, dh0
// (B, W) float32; hs (B, S, W) float32 (the state sequence the forward
// writes for the backward); dlam_part (B, W) float32.  All arithmetic is
// float32; bfloat16 outputs are rounded once, at the store.  Per step:
//
//   log_a = -8 * softplus(lam) * sigmoid(r_t)      a = exp(log_a)
//   mult  = sqrt(max(1 - exp(2 * log_a), 1e-12))
//   h_t   = a * h_{t-1} + mult * (sigmoid(i_t) * x_t)
//
// exp(2 * log_a) is kept as written (not a * a), as both references do.
//
// What bounds it on this card: the recurrence is elementwise over (b, w)
// and serial over t, with ~30 float32 operations per element and step, so
// the operations are negligible and the bytes bound it: at the main path's
// shape (B 2, S 1024, W 2560, bf16) ~63 MB forward (x, r, i, out, and the
// float32 state sequence) over 3.35 TB/s is ~19 us.  But there are only
// B * W = 5120 independent lanes, 160 warps on 132 SMs, each walking a
// 1024-step dependent chain: latency, not bandwidth, bounds it.  The design
// does two things about that.  (1) One thread per lane and one warp per CTA,
// so the 160 warps spread over all SMs instead of crowding 40 of them.
// (2) A time tile of steps held in registers (16 forward, 8 backward):
// the next tile's loads are issued before the current tile's dependent
// updates, and the gates of a tile (sigmoid, exp, sqrt), which do not
// depend on h, can be computed ahead of its chain, so a step of the chain
// costs little more than one FMA's latency rather than a DRAM round trip.  Neighbouring threads read neighbouring w, so every load
// and store of a warp is one contiguous segment.
//
// Two kernels:
//   rglru_fwd  h over t from h0 (or 0); writes out, h_last and, when hs is
//              not null, the float32 state sequence.
//   rglru_bwd  the reverse-time scan: carry = dh_last (or 0); per step
//              dh = dout_t + carry, then dx, dr, di, this lane's dlam
//              partial, carry = a * dh; dh0 is the final carry.  dlam is
//              reduced over t in the thread and written per (b, w): the
//              caller sums the B partials (no atomics, deterministic).
//
// Every entry point launches on the stream it is given and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float RGLRU_C = 8.0f;
constexpr float MULT_FLOOR = 1e-12f;
constexpr int THREADS = 32;  // one warp per CTA
constexpr int TT = 16;       // time steps per register tile, forward
constexpr int TB = 8;        // backward (five inputs a step, not three)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }
// log(1 + e^x) as jax.nn.softplus computes it (logaddexp(x, 0))
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// v[j] = src[base + (t0 + j) * W] for t0 + j in [0, S), else 0
template <int N, typename T>
__device__ __forceinline__ void load_tile(float (&v)[N], const T* __restrict__ src,
                                          size_t base, int t0, int S, int W) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int t = t0 + j;
    v[j] = (t >= 0 && t < S) ? to_f(src[base + (size_t)t * W]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ ig,
                 const float* __restrict__ lam, const float* __restrict__ h0,
                 T* __restrict__ out, float* __restrict__ h_last, float* __restrict__ hs,
                 int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const float log_a_base = -RGLRU_C * softplus(lam[w]);
  const size_t lane = (size_t)b * W + w;
  const size_t base = (size_t)b * S * W + w;  // element (b, 0, w)
  float h = h0 ? h0[lane] : 0.f;

  float cx[TT], cr[TT], ci[TT];
  load_tile(cx, x, base, 0, S, W);
  load_tile(cr, r, base, 0, S, W);
  load_tile(ci, ig, base, 0, S, W);
  for (int t0 = 0; t0 < S; t0 += TT) {
    float nx[TT], nr[TT], ni[TT];
    load_tile(nx, x, base, t0 + TT, S, W);
    load_tile(nr, r, base, t0 + TT, S, W);
    load_tile(ni, ig, base, t0 + TT, S, W);
    float a[TT], g[TT];
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      const float log_a = log_a_base * sigmoid(cr[j]);
      a[j] = expf(log_a);
      const float mult = sqrtf(fmaxf(1.f - expf(2.f * log_a), MULT_FLOOR));
      g[j] = mult * (sigmoid(ci[j]) * cx[j]);
    }
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      const int t = t0 + j;
      if (t < S) {
        h = a[j] * h + g[j];
        out[base + (size_t)t * W] = from_f<T>(h);
        if (hs) hs[base + (size_t)t * W] = h;
      }
    }
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      cx[j] = nx[j];
      cr[j] = nr[j];
      ci[j] = ni[j];
    }
  }
  h_last[lane] = h;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_bwd_kernel(const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ ig,
                 const float* __restrict__ lam, const float* __restrict__ h0,
                 const float* __restrict__ hs, const T* __restrict__ dout,
                 const float* __restrict__ dh_last, T* __restrict__ dx, T* __restrict__ dr,
                 T* __restrict__ di, float* __restrict__ dlam_part, float* __restrict__ dh0,
                 int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const float lw = lam[w];
  const float log_a_base = -RGLRU_C * softplus(lw);
  const float dbase_dlam = -RGLRU_C * sigmoid(lw);  // d softplus / d lam = sigmoid
  const size_t lane = (size_t)b * W + w;
  const size_t base = (size_t)b * S * W + w;
  const float h_init = h0 ? h0[lane] : 0.f;
  float carry = dh_last ? dh_last[lane] : 0.f;
  float dlam = 0.f;

  // tile k covers steps [k * TB, k * TB + TB); walked from the last one down
  const int last = (S - 1) / TB;
  float cx[TB], cr[TB], ci[TB], cd[TB], ch[TB];
  load_tile(cx, x, base, last * TB, S, W);
  load_tile(cr, r, base, last * TB, S, W);
  load_tile(ci, ig, base, last * TB, S, W);
  load_tile(cd, dout, base, last * TB, S, W);
  load_tile(ch, hs, base, last * TB - 1, S, W);  // h_{t-1}; index -1 reads as 0
  for (int k = last; k >= 0; --k) {
    const int t0 = k * TB;
    if (t0 == 0) ch[0] = h_init;
    float nx[TB], nr[TB], ni[TB], nd[TB], nh[TB];
    load_tile(nx, x, base, t0 - TB, S, W);
    load_tile(nr, r, base, t0 - TB, S, W);
    load_tile(ni, ig, base, t0 - TB, S, W);
    load_tile(nd, dout, base, t0 - TB, S, W);
    load_tile(nh, hs, base, t0 - TB - 1, S, W);
#pragma unroll
    for (int j = TB - 1; j >= 0; --j) {
      const int t = t0 + j;
      if (t < S) {
        const float sr = sigmoid(cr[j]);
        const float si = sigmoid(ci[j]);
        const float log_a = log_a_base * sr;
        const float a = expf(log_a);
        const float e2 = expf(2.f * log_a);
        const float one_minus = 1.f - e2;
        const float mult = sqrtf(fmaxf(one_minus, MULT_FLOOR));
        const float dh = cd[j] + carry;
        const float dgated = dh * mult;  // gated = sigmoid(i) * x
        float dlog_a = dh * ch[j] * a;
        // d mult / d log_a = -e2 / mult, and 0 where the floor is taken
        if (one_minus > MULT_FLOOR) dlog_a -= dh * si * cx[j] * e2 / mult;
        carry = a * dh;
        const size_t at = base + (size_t)t * W;
        dx[at] = from_f<T>(dgated * si);
        di[at] = from_f<T>(dgated * cx[j] * si * (1.f - si));
        dr[at] = from_f<T>(dlog_a * log_a_base * sr * (1.f - sr));
        dlam += dlog_a * sr * dbase_dlam;
      }
    }
#pragma unroll
    for (int j = 0; j < TB; ++j) {
      cx[j] = nx[j];
      cr[j] = nr[j];
      ci[j] = ni[j];
      cd[j] = nd[j];
      ch[j] = nh[j];
    }
  }
  dlam_part[lane] = dlam;
  if (dh0) dh0[lane] = carry;
}

dim3 grid_of(int B, int W) { return dim3((W + THREADS - 1) / THREADS, B); }

}  // namespace

// dtype: 0 float32, 1 bfloat16.  h0 and hs may be null (zeros; no state
// sequence written).
extern "C" int rglru_fwd(const void* x, const void* r, const void* i, const float* lam,
                         const float* h0, void* out, float* h_last, float* hs, int B, int S,
                         int W, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    rglru_fwd_kernel<float><<<grid_of(B, W), THREADS, 0, st>>>(
        (const float*)x, (const float*)r, (const float*)i, lam, h0, (float*)out, h_last, hs,
        S, W);
  else if (dtype == 1)
    rglru_fwd_kernel<__nv_bfloat16><<<grid_of(B, W), THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)r, (const __nv_bfloat16*)i, lam, h0,
        (__nv_bfloat16*)out, h_last, hs, S, W);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// h0, dh_last and dh0 may be null (zeros in; dh0 not written).
extern "C" int rglru_bwd(const void* x, const void* r, const void* i, const float* lam,
                         const float* h0, const float* hs, const void* dout,
                         const float* dh_last, void* dx, void* dr, void* di, float* dlam_part,
                         float* dh0, int B, int S, int W, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    rglru_bwd_kernel<float><<<grid_of(B, W), THREADS, 0, st>>>(
        (const float*)x, (const float*)r, (const float*)i, lam, h0, hs, (const float*)dout,
        dh_last, (float*)dx, (float*)dr, (float*)di, dlam_part, dh0, S, W);
  else if (dtype == 1)
    rglru_bwd_kernel<__nv_bfloat16><<<grid_of(B, W), THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)r, (const __nv_bfloat16*)i, lam, h0,
        hs, (const __nv_bfloat16*)dout, dh_last, (__nv_bfloat16*)dx, (__nv_bfloat16*)dr,
        (__nv_bfloat16*)di, dlam_part, dh0, S, W);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
