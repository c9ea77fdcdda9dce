// RG-LRU scan, forward and backward, for Hopper (sm_90a), as a
// chunk-parallel scan over time.
//
// Replaces the TPU kernel src/repro/kernels/rglru.py::_rglru_kernel (the
// Pallas forward); the backward has no TPU counterpart (its reference is
// jax.grad of repro.kernels.ref.rglru).
//
// Layout: x, r, i, out, dout, dx, dr, di (B, S, W) contiguous, float32 or
// bfloat16 (one dtype for all); lam (W,) float32; h0, h_last, dh_last, dh0
// (B, W) float32; hs (B, S, W) float32 (the state sequence the forward
// writes for the backward); dlam_part (NC, B, W) float32, one partial of
// dlam per chunk, summed by the caller; scratch (2, NC - 1, B, W) float32,
// with NC = ceil(S / 32).  All arithmetic is float32; bfloat16 outputs are
// rounded once, at the store.  Per step, in gates() (the one place every
// kernel computes them, so the chunk products and the step scans use the
// same a_t):
//
//   log_a = -8 * softplus(lam) * sigmoid(r_t)      a = exp(log_a)
//   mult  = sqrt(max(1 - exp(2 * log_a), 1e-12))
//   h_t   = a * h_{t-1} + b_t,    b_t = mult * (sigmoid(i_t) * x_t)
//
// exp(2 * log_a) is kept as written (not a * a), as both references do.
//
// What bounds it on this card: the recurrence is elementwise over (b, w)
// and serial over t, with ~21 float32 operations per element and step
// forward (~38 backward), so the bytes bound it: at the main path's shape
// (B 2, S 1024, W 2560, bf16) ~63 MB forward (x, r, i, out, and the
// float32 state sequence) over 3.35 TB/s is ~19 us, ~94 MB backward ~28
// us.  A step scan has only B * W = 5120 independent chains of S = 1024
// dependent steps: 160 warps on 132 SMs, too few loads in flight to stream
// at that rate, and too few warps to hide the latency of each step's gate
// arithmetic (~70 instructions an element: three exps, two reciprocals, a
// square root).  h_t = a_t h_{t-1} + b_t is linear with a per-lane scalar
// decay, so time is cut into chunks of CK = 32 steps (the last one ragged)
// and only a short combine over the chunks stays sequential:
//
//   forward   1. rglru_local_fwd_kernel, per (b, lane, chunk c <
//                NC - 1): the chunk's end state from zero, U_c, and its
//                decay product A_c = prod a_t;
//             2. rglru_combine_kernel, per lane, over the chunks in order
//                from h0 (or 0): h_start(c + 1) = A_c h_start(c) + U_c;
//             3. rglru_fwd_out_kernel, per (b, lane, chunk): the step
//                recurrence from h_start(c), writing out, the states and
//                (last chunk) h_last.
//   backward  the carry recurrence carry_{t-1} = a_t (dout_t + carry_t) is
//             the same in reverse time:
//             1. rglru_local_bwd_kernel, per chunk c > 0: the carry the
//                chunk passes down from zero, V_c, and A_c (reads r, dout);
//             2. rglru_combine_kernel in reverse from dh_last (or 0):
//                carry_end(c - 1) = A_c carry_end(c) + V_c;
//             3. rglru_bwd_chunk_kernel, per chunk: the reverse walk from
//                carry_end(c), reading x, r, i, dout and h_{t-1} (h0 at t =
//                0), writing dx, dr, di once and a dlam partial per (chunk,
//                b, w); chunk 0 writes dh0.
//
// At the main path's shape that is 32 * 5120 = 163 840 chains of 32 steps.
// The chunk algebra takes only products of a_t (no log, no division by a),
// so a -> 1 and a decay product that underflows to 0 stay exact.  A thread
// issues the next tile's loads before the current tile's dependent chain.
// Small tiles keep the registers a thread needs low (40-96), so 20-40
// warps an SM hide the gates' latency: forward, a thread owns one lane and tiles
// of 4 steps (bf16; 2 in float32); backward, two adjacent lanes (one bf16x2
// or float2 load a step and input, a warp reading one 128-byte segment a
// step) and tiles of 4 steps (2 in float32), or one lane where W is odd or
// an input is off its pair alignment.  (Measured on the card against
// 64-step chunks, 16-step tiles, and one or two lanes either way: PERF.md.)
// No atomics: dlam's partials are summed by the caller in a fixed order, so
// every output is bitwise deterministic.
//
// Every entry point launches on the stream it is given and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float RGLRU_C = 8.0f;
constexpr float MULT_FLOOR = 1e-12f;
constexpr int CK = 32;        // chunk length (steps)
constexpr int THREADS = 64;   // threads a CTA of the per-chunk kernels
constexpr int COMBINE_THREADS = 256;
constexpr int COMBINE_BATCH = 8;  // chunks whose loads the combine issues together

// steps per register tile, for V lanes a thread: forward (three inputs a
// step), backward (four inputs and the f32 state)
template <typename T, int V> struct Tile {
  static constexpr int FWD = V * (sizeof(T) == 2 ? 4 : 2);
  static constexpr int BWD = V * (sizeof(T) == 2 ? 2 : 1);
};

// V adjacent lanes of T as one load
template <typename T, int V> struct Lanes;
template <> struct Lanes<float, 1> { using R = float; };
template <> struct Lanes<float, 2> { using R = float2; };
template <> struct Lanes<__nv_bfloat16, 1> { using R = __nv_bfloat16; };
template <> struct Lanes<__nv_bfloat16, 2> { using R = __nv_bfloat162; };

__device__ __forceinline__ void unpack(float v, float (&f)[1]) { f[0] = v; }
__device__ __forceinline__ void unpack(float2 v, float (&f)[2]) { f[0] = v.x; f[1] = v.y; }
__device__ __forceinline__ void unpack(__nv_bfloat16 v, float (&f)[1]) {
  f[0] = __bfloat162float(v);
}
__device__ __forceinline__ void unpack(__nv_bfloat162 v, float (&f)[2]) {
  f[0] = __low2float(v);
  f[1] = __high2float(v);
}
__device__ __forceinline__ void pack(float& o, const float (&f)[1]) { o = f[0]; }
__device__ __forceinline__ void pack(float2& o, const float (&f)[2]) {
  o = make_float2(f[0], f[1]);
}
__device__ __forceinline__ void pack(__nv_bfloat16& o, const float (&f)[1]) {
  o = __float2bfloat16(f[0]);
}
__device__ __forceinline__ void pack(__nv_bfloat162& o, const float (&f)[2]) {
  o = __floats2bfloat162_rn(f[0], f[1]);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }
// log(1 + e^x) as jax.nn.softplus computes it (logaddexp(x, 0))
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// One step's gates, and the partials the backward needs.  base = -8 *
// softplus(lam).  A caller that reads only a (or a and b) leaves the rest
// to dead-code elimination.
struct Gates {
  float a, b, sr, si, e2, mult;
  bool floored;  // 1 - exp(2 log_a) under the floor: mult's gradient is 0
};

__device__ __forceinline__ Gates gates(float base, float x, float r, float i) {
  Gates g;
  g.sr = sigmoid(r);
  const float log_a = base * g.sr;
  g.a = expf(log_a);
  g.e2 = expf(2.f * log_a);
  const float one_minus = 1.f - g.e2;
  g.floored = !(one_minus > MULT_FLOOR);
  g.mult = sqrtf(fmaxf(one_minus, MULT_FLOOR));
  g.si = sigmoid(i);
  g.b = g.mult * (g.si * x);
  return g;
}

// This thread's lanes w0 .. w0 + V - 1 of batch row b, in chunk c
// (blockIdx.y + first); R-typed offsets of a (B, S, W) tensor and of a
// (slots, B, W) buffer.
template <int V>
struct Lane {
  int w0, b, c, B, NC, c0, c1;
  size_t wv, Wv;  // this thread's pair, and a row, in V-lane units
  __device__ Lane(int S, int W, int first) {
    w0 = (blockIdx.x * THREADS + threadIdx.x) * V;
    b = blockIdx.z;
    B = gridDim.z;
    c = blockIdx.y + first;
    NC = (S + CK - 1) / CK;
    c0 = c * CK;
    c1 = min(c0 + CK, S);
    wv = (size_t)w0 / V;
    Wv = (size_t)W / V;
  }
  // element (b, t, w0) of a (B, S, W) tensor
  __device__ size_t at(int t, int S) const { return ((size_t)b * S + t) * Wv + wv; }
  // element (slot, b, w0) of a (slots, B, W) buffer
  __device__ size_t slot(int s) const { return ((size_t)s * B + b) * Wv + wv; }
};

// v[j] = src[ln.at(t0 + j)] for t0 + j in [lo, hi); the rest is left unread
template <int N, typename R, int V>
__device__ __forceinline__ void load_tile(R (&v)[N], const R* __restrict__ src,
                                          const Lane<V>& ln, int S, int t0, int lo, int hi) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int t = t0 + j;
    if (t >= lo && t < hi) v[j] = src[ln.at(t, S)];
  }
}

template <int N, typename R>
__device__ __forceinline__ void copy_tile(R (&dst)[N], const R (&src)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) dst[j] = src[j];
}

template <int V>
__device__ __forceinline__ void lane_bases(const float* __restrict__ lam, int w0,
                                           float (&base)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) base[v] = -RGLRU_C * softplus(lam[w0 + v]);
}

template <int V>
__device__ __forceinline__ void store_slot(float* __restrict__ buf, const Lane<V>& ln, int s,
                                           const float (&f)[V]) {
  typename Lanes<float, V>::R o;
  pack(o, f);
  reinterpret_cast<typename Lanes<float, V>::R*>(buf)[ln.slot(s)] = o;
}

template <int V>
__device__ __forceinline__ void load_slot(const float* __restrict__ buf, const Lane<V>& ln,
                                          int s, float (&f)[V]) {
  unpack(reinterpret_cast<const typename Lanes<float, V>::R*>(buf)[ln.slot(s)], f);
}

// Forward phase 1, per (b, lane, chunk c < NC - 1; every such chunk is
// whole): U_c = the recurrence from h = 0 over the chunk, A_c = prod a_t;
// written to slot c of abuf / ubuf.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
rglru_local_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                       const T* __restrict__ ig, const float* __restrict__ lam,
                       float* __restrict__ abuf, float* __restrict__ ubuf, int S, int W) {
  using R = typename Lanes<T, V>::R;
  constexpr int TT = Tile<T, V>::FWD;
  const Lane<V> ln(S, W, 0);
  if (ln.w0 >= W) return;
  const R* xv = reinterpret_cast<const R*>(x);
  const R* rv = reinterpret_cast<const R*>(r);
  const R* iv = reinterpret_cast<const R*>(ig);
  float base[V], u[V], A[V];
  lane_bases<V>(lam, ln.w0, base);
#pragma unroll
  for (int v = 0; v < V; ++v) u[v] = 0.f, A[v] = 1.f;

  R cx[TT], cr[TT], ci[TT];
  load_tile(cx, xv, ln, S, ln.c0, ln.c0, ln.c1);
  load_tile(cr, rv, ln, S, ln.c0, ln.c0, ln.c1);
  load_tile(ci, iv, ln, S, ln.c0, ln.c0, ln.c1);
#pragma unroll 1
  for (int t0 = ln.c0; t0 < ln.c1; t0 += TT) {
    R nx[TT], nr[TT], ni[TT];
    load_tile(nx, xv, ln, S, t0 + TT, ln.c0, ln.c1);
    load_tile(nr, rv, ln, S, t0 + TT, ln.c0, ln.c1);
    load_tile(ni, iv, ln, S, t0 + TT, ln.c0, ln.c1);
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      float fx[V], fr[V], fi[V];
      unpack(cx[j], fx);
      unpack(cr[j], fr);
      unpack(ci[j], fi);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const Gates g = gates(base[v], fx[v], fr[v], fi[v]);
        u[v] = g.a * u[v] + g.b;
        A[v] *= g.a;
      }
    }
    copy_tile(cx, nx);
    copy_tile(cr, nr);
    copy_tile(ci, ni);
  }
  store_slot<V>(abuf, ln, ln.c, A);
  store_slot<V>(ubuf, ln, ln.c, u);
}

// Backward phase 1, per (b, lane pair, chunk c > 0): V_c = the carry the
// chunk passes down (dh = dout_t + carry; carry = a_t dh, from the chunk's
// last step to its first) from carry = 0, A_c = prod a_t; written to slot
// c - 1 of abuf / vbuf.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
rglru_local_bwd_kernel(const T* __restrict__ r, const T* __restrict__ dout,
                       const float* __restrict__ lam, float* __restrict__ abuf,
                       float* __restrict__ vbuf, int S, int W) {
  using R = typename Lanes<T, V>::R;
  constexpr int TT = Tile<T, V>::FWD;  // two inputs a step
  const Lane<V> ln(S, W, 1);
  if (ln.w0 >= W) return;
  const R* rv = reinterpret_cast<const R*>(r);
  const R* dv = reinterpret_cast<const R*>(dout);
  float base[V], carry[V], A[V];
  lane_bases<V>(lam, ln.w0, base);
#pragma unroll
  for (int v = 0; v < V; ++v) carry[v] = 0.f, A[v] = 1.f;

  // tile k covers steps [c0 + k TT, c0 + k TT + TT); walked from the last
  const int last = (ln.c1 - ln.c0 - 1) / TT;
  R cr[TT], cd[TT];
  load_tile(cr, rv, ln, S, ln.c0 + last * TT, ln.c0, ln.c1);
  load_tile(cd, dv, ln, S, ln.c0 + last * TT, ln.c0, ln.c1);
#pragma unroll 1
  for (int k = last; k >= 0; --k) {
    const int t0 = ln.c0 + k * TT;
    R nr[TT], nd[TT];
    load_tile(nr, rv, ln, S, t0 - TT, ln.c0, ln.c1);
    load_tile(nd, dv, ln, S, t0 - TT, ln.c0, ln.c1);
#pragma unroll
    for (int j = TT - 1; j >= 0; --j) {
      if (t0 + j < ln.c1) {
        float fr[V], fd[V];
        unpack(cr[j], fr);
        unpack(cd[j], fd);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float a = gates(base[v], 0.f, fr[v], 0.f).a;
          carry[v] = a * (fd[v] + carry[v]);
          A[v] *= a;
        }
      }
    }
    copy_tile(cr, nr);
    copy_tile(cd, nd);
  }
  store_slot<V>(abuf, ln, ln.c - 1, A);
  store_slot<V>(vbuf, ln, ln.c - 1, carry);
}

// Phase 2 of both directions, per lane (b, w), over the nslots chunk slots
// in order (in reverse when REV): y <- A_s y + U_s from init (or 0), each
// y written back over U_s.  Forward: slot c ends holding h_start(c + 1);
// backward: slot c - 1 ends holding carry_end(c - 1).
template <bool REV>
__global__ void __launch_bounds__(COMBINE_THREADS)
rglru_combine_kernel(const float* __restrict__ abuf, float* __restrict__ ubuf,
                     const float* __restrict__ init, int nslots, int BW) {
  const int lane = blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (lane >= BW) return;
  float y = init ? init[lane] : 0.f;
#pragma unroll 1
  for (int s0 = 0; s0 < nslots; s0 += COMBINE_BATCH) {
    float a[COMBINE_BATCH], u[COMBINE_BATCH];
#pragma unroll
    for (int k = 0; k < COMBINE_BATCH; ++k) {
      const int s = REV ? nslots - 1 - (s0 + k) : s0 + k;
      if (s0 + k < nslots) {
        a[k] = abuf[(size_t)s * BW + lane];
        u[k] = ubuf[(size_t)s * BW + lane];
      }
    }
#pragma unroll
    for (int k = 0; k < COMBINE_BATCH; ++k) {
      const int s = REV ? nslots - 1 - (s0 + k) : s0 + k;
      if (s0 + k < nslots) {
        y = a[k] * y + u[k];
        ubuf[(size_t)s * BW + lane] = y;
      }
    }
  }
}

// Forward phase 3, per (b, lane, chunk): the step recurrence from the
// chunk's start (h0 or 0 for chunk 0, else slot c - 1 of starts), writing
// out, the f32 states when hs is not null, and h_last from the last chunk.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
rglru_fwd_out_kernel(const T* __restrict__ x, const T* __restrict__ r,
                     const T* __restrict__ ig, const float* __restrict__ lam,
                     const float* __restrict__ h0, const float* __restrict__ starts,
                     T* __restrict__ out, float* __restrict__ h_last, float* __restrict__ hs,
                     int S, int W) {
  using R = typename Lanes<T, V>::R;
  using F = typename Lanes<float, V>::R;
  constexpr int TT = Tile<T, V>::FWD;
  const Lane<V> ln(S, W, 0);
  if (ln.w0 >= W) return;
  const R* xv = reinterpret_cast<const R*>(x);
  const R* rv = reinterpret_cast<const R*>(r);
  const R* iv = reinterpret_cast<const R*>(ig);
  R* ov = reinterpret_cast<R*>(out);
  F* hv = reinterpret_cast<F*>(hs);
  float base[V], h[V];
  lane_bases<V>(lam, ln.w0, base);
  if (ln.c > 0) {
    load_slot<V>(starts, ln, ln.c - 1, h);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) h[v] = h0 ? h0[(size_t)ln.b * W + ln.w0 + v] : 0.f;
  }

  R cx[TT], cr[TT], ci[TT];
  load_tile(cx, xv, ln, S, ln.c0, ln.c0, ln.c1);
  load_tile(cr, rv, ln, S, ln.c0, ln.c0, ln.c1);
  load_tile(ci, iv, ln, S, ln.c0, ln.c0, ln.c1);
#pragma unroll 1
  for (int t0 = ln.c0; t0 < ln.c1; t0 += TT) {
    R nx[TT], nr[TT], ni[TT];
    load_tile(nx, xv, ln, S, t0 + TT, ln.c0, ln.c1);
    load_tile(nr, rv, ln, S, t0 + TT, ln.c0, ln.c1);
    load_tile(ni, iv, ln, S, t0 + TT, ln.c0, ln.c1);
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      const int t = t0 + j;
      if (t < ln.c1) {
        float fx[V], fr[V], fi[V];
        unpack(cx[j], fx);
        unpack(cr[j], fr);
        unpack(ci[j], fi);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const Gates g = gates(base[v], fx[v], fr[v], fi[v]);
          h[v] = g.a * h[v] + g.b;
        }
        R o;
        pack(o, h);
        ov[ln.at(t, S)] = o;
        if (hv) {
          F s;
          pack(s, h);
          hv[ln.at(t, S)] = s;
        }
      }
    }
    copy_tile(cx, nx);
    copy_tile(cr, nr);
    copy_tile(ci, ni);
  }
  if (ln.c == ln.NC - 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) h_last[(size_t)ln.b * W + ln.w0 + v] = h[v];
  }
}

// Backward phase 3, per (b, lane pair, chunk): from the carry at the chunk's
// end (dh_last or 0 for the last chunk, else slot c of carries), per step
// from the chunk's last to its first: dh = dout_t + carry, then dx, dr, di,
// this chunk's dlam partial, carry = a dh.  Chunk 0 writes its final carry
// as dh0.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
rglru_bwd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ r,
                       const T* __restrict__ ig, const float* __restrict__ lam,
                       const float* __restrict__ h0, const float* __restrict__ hs,
                       const T* __restrict__ dout, const float* __restrict__ dh_last,
                       const float* __restrict__ carries, T* __restrict__ dx,
                       T* __restrict__ dr, T* __restrict__ di, float* __restrict__ dlam_part,
                       float* __restrict__ dh0, int S, int W) {
  using R = typename Lanes<T, V>::R;
  using F = typename Lanes<float, V>::R;
  constexpr int TB = Tile<T, V>::BWD;
  const Lane<V> ln(S, W, 0);
  if (ln.w0 >= W) return;
  const R* xv = reinterpret_cast<const R*>(x);
  const R* rv = reinterpret_cast<const R*>(r);
  const R* iv = reinterpret_cast<const R*>(ig);
  const R* dv = reinterpret_cast<const R*>(dout);
  const F* hv = reinterpret_cast<const F*>(hs);
  R* dxo = reinterpret_cast<R*>(dx);
  R* dro = reinterpret_cast<R*>(dr);
  R* dio = reinterpret_cast<R*>(di);
  float base[V], dbase[V], carry[V], dlam[V], h_init[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float lw = lam[ln.w0 + v];
    base[v] = -RGLRU_C * softplus(lw);
    dbase[v] = -RGLRU_C * sigmoid(lw);  // d softplus / d lam = sigmoid
    dlam[v] = 0.f;
    h_init[v] = h0 ? h0[(size_t)ln.b * W + ln.w0 + v] : 0.f;
  }
  if (ln.c < ln.NC - 1) {
    load_slot<V>(carries, ln, ln.c, carry);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      carry[v] = dh_last ? dh_last[(size_t)ln.b * W + ln.w0 + v] : 0.f;
  }
  F hinit;
  pack(hinit, h_init);

  // tile k covers steps [c0 + k TB, c0 + k TB + TB); walked from the last;
  // ch[j] holds h_{t-1} (h0 at t = 0)
  const int last = (ln.c1 - ln.c0 - 1) / TB;
  R cx[TB], cr[TB], ci[TB], cd[TB];
  F ch[TB];
  int t0 = ln.c0 + last * TB;
  load_tile(cx, xv, ln, S, t0, ln.c0, ln.c1);
  load_tile(cr, rv, ln, S, t0, ln.c0, ln.c1);
  load_tile(ci, iv, ln, S, t0, ln.c0, ln.c1);
  load_tile(cd, dv, ln, S, t0, ln.c0, ln.c1);
  load_tile(ch, hv, ln, S, t0 - 1, max(ln.c0 - 1, 0), ln.c1 - 1);
#pragma unroll 1
  for (int k = last; k >= 0; --k) {
    t0 = ln.c0 + k * TB;
    if (t0 == 0) ch[0] = hinit;
    R nx[TB], nr[TB], ni[TB], nd[TB];
    F nh[TB];
    load_tile(nx, xv, ln, S, t0 - TB, ln.c0, ln.c1);
    load_tile(nr, rv, ln, S, t0 - TB, ln.c0, ln.c1);
    load_tile(ni, iv, ln, S, t0 - TB, ln.c0, ln.c1);
    load_tile(nd, dv, ln, S, t0 - TB, ln.c0, ln.c1);
    load_tile(nh, hv, ln, S, t0 - TB - 1, max(ln.c0 - 1, 0), ln.c1 - 1);
#pragma unroll
    for (int j = TB - 1; j >= 0; --j) {
      const int t = t0 + j;
      if (t < ln.c1) {
        float fx[V], fr[V], fi[V], fd[V], fh[V], gx[V], gr[V], gi[V];
        unpack(cx[j], fx);
        unpack(cr[j], fr);
        unpack(ci[j], fi);
        unpack(cd[j], fd);
        unpack(ch[j], fh);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const Gates g = gates(base[v], fx[v], fr[v], fi[v]);
          const float dh = fd[v] + carry[v];
          const float dgated = dh * g.mult;  // gated = sigmoid(i) * x
          float dlog_a = dh * fh[v] * g.a;
          // d mult / d log_a = -e2 / mult, and 0 where the floor is taken
          if (!g.floored) dlog_a -= dh * g.si * fx[v] * g.e2 / g.mult;
          carry[v] = g.a * dh;
          gx[v] = dgated * g.si;
          gi[v] = dgated * fx[v] * g.si * (1.f - g.si);
          gr[v] = dlog_a * base[v] * g.sr * (1.f - g.sr);
          dlam[v] += dlog_a * g.sr * dbase[v];
        }
        const size_t at = ln.at(t, S);
        R o;
        pack(o, gx);
        dxo[at] = o;
        pack(o, gr);
        dro[at] = o;
        pack(o, gi);
        dio[at] = o;
      }
    }
    copy_tile(cx, nx);
    copy_tile(cr, nr);
    copy_tile(ci, ni);
    copy_tile(cd, nd);
    copy_tile(ch, nh);
  }
  store_slot<V>(dlam_part, ln, ln.c, dlam);
  if (ln.c == 0 && dh0) {
#pragma unroll
    for (int v = 0; v < V; ++v) dh0[(size_t)ln.b * W + ln.w0 + v] = carry[v];
  }
}

dim3 grid_of(int W, int V, int chunks, int B) {
  return dim3((W + V * THREADS - 1) / (V * THREADS), chunks, B);
}

unsigned combine_blocks(int BW) { return (unsigned)((BW + COMBINE_THREADS - 1) / COMBINE_THREADS); }

// The two-lane backward needs W even and every (B, S, W) pointer on a
// boundary of two elements.
template <typename T>
bool pairs_ok(int W, const void* const* ts, int nt, const float* hs) {
  if (W % 2) return false;
  for (int k = 0; k < nt; ++k)
    if ((uintptr_t)ts[k] % (2 * sizeof(T))) return false;
  return (uintptr_t)hs % (2 * sizeof(float)) == 0;
}

template <typename T, int V>
cudaError_t launch_fwd(const void* x, const void* r, const void* i, const float* lam,
                       const float* h0, void* out, float* h_last, float* hs, float* scratch,
                       int B, int S, int W, cudaStream_t st) {
  const int NC = (S + CK - 1) / CK;
  const size_t BW = (size_t)B * W;
  float* abuf = scratch;
  float* ubuf = scratch + (size_t)(NC - 1) * BW;
  if (NC > 1) {
    rglru_local_fwd_kernel<T, V><<<grid_of(W, V, NC - 1, B), THREADS, 0, st>>>(
        (const T*)x, (const T*)r, (const T*)i, lam, abuf, ubuf, S, W);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    rglru_combine_kernel<false><<<combine_blocks((int)BW), COMBINE_THREADS, 0, st>>>(
        abuf, ubuf, h0, NC - 1, (int)BW);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  rglru_fwd_out_kernel<T, V><<<grid_of(W, V, NC, B), THREADS, 0, st>>>(
      (const T*)x, (const T*)r, (const T*)i, lam, h0, ubuf, (T*)out, h_last, hs, S, W);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_bwd(const void* x, const void* r, const void* i, const float* lam,
                       const float* h0, const float* hs, const void* dout,
                       const float* dh_last, void* dx, void* dr, void* di, float* dlam_part,
                       float* dh0, float* scratch, int B, int S, int W, cudaStream_t st) {
  const int NC = (S + CK - 1) / CK;
  const size_t BW = (size_t)B * W;
  float* abuf = scratch;
  float* vbuf = scratch + (size_t)(NC - 1) * BW;
  if (NC > 1) {
    rglru_local_bwd_kernel<T, V><<<grid_of(W, V, NC - 1, B), THREADS, 0, st>>>(
        (const T*)r, (const T*)dout, lam, abuf, vbuf, S, W);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    rglru_combine_kernel<true><<<combine_blocks((int)BW), COMBINE_THREADS, 0, st>>>(
        abuf, vbuf, dh_last, NC - 1, (int)BW);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  rglru_bwd_chunk_kernel<T, V><<<grid_of(W, V, NC, B), THREADS, 0, st>>>(
      (const T*)x, (const T*)r, (const T*)i, lam, h0, hs, (const T*)dout, dh_last, vbuf,
      (T*)dx, (T*)dr, (T*)di, dlam_part, dh0, S, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const void* x, const void* r, const void* i, const float* lam,
                         const float* h0, const float* hs, const void* dout,
                         const float* dh_last, void* dx, void* dr, void* di, float* dlam_part,
                         float* dh0, float* scratch, int B, int S, int W, cudaStream_t st) {
  const void* ts[] = {x, r, i, dout, dx, dr, di};
  if (pairs_ok<T>(W, ts, 7, hs))
    return launch_bwd<T, 2>(x, r, i, lam, h0, hs, dout, dh_last, dx, dr, di, dlam_part, dh0,
                            scratch, B, S, W, st);
  return launch_bwd<T, 1>(x, r, i, lam, h0, hs, dout, dh_last, dx, dr, di, dlam_part, dh0,
                          scratch, B, S, W, st);
}

// out = {registers a thread, shared bytes, threads, CTAs per SM}
template <typename K>
cudaError_t occupancy(K kern, int threads, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kern, threads, 0);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = threads;
  return cudaSuccess;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  h0 and hs may be null (zeros in; no state
// sequence written).  scratch: (2, NC - 1, B, W) float32 (unused, and may be
// null, when S <= 32).
extern "C" int rglru_fwd(const void* x, const void* r, const void* i, const float* lam,
                         const float* h0, void* out, float* h_last, float* hs, float* scratch,
                         int B, int S, int W, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_fwd<float, 1>(x, r, i, lam, h0, out, h_last, hs, scratch, B, S, W, st);
  if (dtype == 1)
    return (int)launch_fwd<__nv_bfloat16, 1>(x, r, i, lam, h0, out, h_last, hs, scratch, B,
                                              S, W, st);
  return (int)cudaErrorInvalidValue;
}

// h0, dh_last and dh0 may be null (zeros in; dh0 not written).  dlam_part:
// (NC, B, W) float32; scratch as for rglru_fwd.
extern "C" int rglru_bwd(const void* x, const void* r, const void* i, const float* lam,
                         const float* h0, const float* hs, const void* dout,
                         const float* dh_last, void* dx, void* dr, void* di, float* dlam_part,
                         float* dh0, float* scratch, int B, int S, int W, int dtype,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)dispatch_bwd<float>(x, r, i, lam, h0, hs, dout, dh_last, dx, dr, di, dlam_part,
                                    dh0, scratch, B, S, W, st);
  if (dtype == 1)
    return (int)dispatch_bwd<__nv_bfloat16>(x, r, i, lam, h0, hs, dout, dh_last, dx, dr, di,
                                            dlam_part, dh0, scratch, B, S, W, st);
  return (int)cudaErrorInvalidValue;
}

// The resources of one kernel's bfloat16 instantiation on the main path
// (one lane a thread forward, two backward; which: 0 local forward, 1
// local backward, 2 combine, 3 forward output, 4 backward chunk):
// out = {registers a thread, shared bytes, threads, CTAs per SM}.
extern "C" int rglru_occupancy(int which, int* out) {
  using T = __nv_bfloat16;
  switch (which) {
    case 0: return (int)occupancy(rglru_local_fwd_kernel<T, 1>, THREADS, out);
    case 1: return (int)occupancy(rglru_local_bwd_kernel<T, 2>, THREADS, out);
    case 2: return (int)occupancy(rglru_combine_kernel<false>, COMBINE_THREADS, out);
    case 3: return (int)occupancy(rglru_fwd_out_kernel<T, 1>, THREADS, out);
    case 4: return (int)occupancy(rglru_bwd_chunk_kernel<T, 2>, THREADS, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
