// RWKV6 (Finch) wkv scan, forward and backward, for Hopper (sm_90a), as a
// chunk-parallel exact scan.
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py::_wkv6_kernel (the
// Pallas forward); the backward has no TPU counterpart (its reference is
// jax.grad of repro.kernels.ref.wkv6).
//
// Per (b, h), with the state S in R^{hd x hd} (row i = key channel,
// column j = value channel), every step in float32:
//
//   o_t[j]    = sum_i r_t[i] * S_{t-1}[i,j] + (sum_i r_t[i] u[i] k_t[i]) * v_t[j]
//   S_t[i,j]  = w_t[i] * S_{t-1}[i,j] + k_t[i] * v_t[j]
//
// This is the reference's step recurrence (repro.kernels.ref.wkv6), not the
// Pallas kernel's chunked log-decay form: k * exp(-cumsum(log w)) overflows
// float32 once the decay over a 64-token block passes e^-88.  Nothing here
// takes a log, an exp or a quotient of w: only products of w, so w = 0 and
// w = 1 stay exact and an underflow to 0 is the true value.
//
// Layout: r, k, v, w, out, dout, dr, dk, dv, dw (B, S, H, hd) contiguous,
// float32 or bfloat16 (one dtype for all); u (H, hd) float32; s0, s_last,
// ds_last, ds0 (B, H, hd, hd) float32; ckpt (B, H, NC, hd, hd) float32 with
// NC = ceil(S / 64): the state before steps 0, 64, 128, ...; the scratch
// gbuf (B, H, NC, hd, hd) and dbuf (B, H, NC, hd) float32; du_part
// (B, NC, H, hd) float32, one partial of du per chunk, summed by the caller.
// hd is 32 or 64.
//
// What bounds it on this card: at the main path's shape (B 2, S 1024, H 32,
// hd 64, bf16) the function needs ~5 float32 operations per state entry and
// step forward (1.36 GFLOP, ~20 us on the CUDA cores) and ~14 backward,
// while it moves only ~60 MB; so the float32 rate, if the work is spread
// over enough warps.  The step scan has only B * H = 64 chains of S = 1024
// dependent steps.  The design cuts time into chunks of CK = 64 steps, so
// that only a short combine over NC = S / 64 chunks stays sequential:
//
//   forward   1. wkv6_local_kernel, per (b, h, chunk): the chunk's end state
//                from zero, U_c (the step recurrence), and its decay product
//                D_c = prod_s w_s;
//             2. wkv6_combine_kernel, per state entry, over the chunks in
//                order: S_{c+1} = D_c * S_c + U_c.  The chunk-start states
//                S_c are the checkpoints the backward reads;
//             3. wkv6_fwd_out_kernel, per (b, h, chunk): the step recurrence
//                from S_c, writing o.  A thread holds a block of 4 value
//                columns over a quarter of the key rows, so o_t[j] is a dot
//                product in the thread plus one 4-lane reduce-scatter; r, k,
//                w of a tile of 16 steps are read as vectors from shared
//                memory; the u bonus is one dot product per step,
//                (r . (u * k)) v_t, in O(hd).
//   backward  1. wkv6_local_kernel in reverse time: the chunk's local state
//                cotangent V_c (G_{t-1} = w_t G_t + r_t do_t^T from zero at
//                the chunk's end) and D_c;
//             2. wkv6_combine_kernel in reverse: G at the end of chunk c - 1
//                = D_c * G_end(c) + V_c, from ds_last; ds0 comes out last;
//             3. wkv6_bwd_chunk_kernel, per (b, h, chunk): rebuilds the
//                chunk's states S_{t-1} from its checkpoint and walks them
//                back from G_end(c), writing dr, dk, dv, dw and du's partial.
//
// The backward's chunk kernel needs S_{t-1} and G_t at the same t while it
// walks time in reverse.  It never divides by w (S_{t-1} = (S_t - k v^T) / w
// fails as w -> 0).  One CTA of 8 warps owns a whole (b, h, chunk): a warp
// is a group of 8 value columns over all hd key rows, a thread owns 2
// adjacent rows of them (1 at hd 32).  The CTA keeps the state at each
// 16-step segment's start in shared memory (64 KB at hd 64), and for each
// 4-step sub-tile, from the last, rebuilds the sub-tile's 4 states from its
// segment's start into registers and walks them back.  dv (a sum over the
// key rows) is a reduce-scatter inside the warp; dr, dk and dw (sums over
// the value columns) are summed over the 8 warps through shared memory in a
// fixed order: no atomics, deterministic, each written once in r's dtype.
// dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j], with no division by w.  Shared
// memory stays at 112 KB and registers at 128 a thread, so two CTAs share an
// SM and each hides the other's loads and barriers.
//
// On an NVIDIA H100 80GB HBM3 at 700.00 W, at the main path's shape:
// wkv6_fwd 0.119 ms and wkv6_bwd 0.335 ms (bounds 0.020 and 0.056 ms), from
// 0.480 and 1.053 ms for the step-scan kernels these replaced (PERF.md).
//
// Every entry point launches on the stream it is given and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CK = 64;   // chunk length = checkpoint interval of the forward (steps)
constexpr int TL = 16;   // steps per tile staged in shared memory (a backward segment)
constexpr int NSEG = CK / TL;
constexpr int COMBINE_THREADS = 256;
constexpr int COMBINE_BATCH = 8;  // chunks whose loads the combine issues together
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The sum over the warp's 32 lanes of v[c] for c = lane / (32 / N): lanes
// (32 / N) c .. (32 / N) (c + 1) - 1 all return it.  Each level halves the
// values a lane keeps and adds its partner's half (N - 1 shuffles), then
// the last levels add whole values (log2(32 / N) shuffles).  v is spent.
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&v)[N], int lane) {
  int off = 16;
#pragma unroll
  for (int n = N; n > 1; n >>= 1, off >>= 1) {
    const bool hi = lane & off;
#pragma unroll
    for (int c = 0; c < n / 2; ++c) {
      const float keep = hi ? v[c + n / 2] : v[c], send = hi ? v[c] : v[c + n / 2];
      v[c] = keep + __shfl_xor_sync(FULL, send, off);
    }
  }
  float x = v[0];
#pragma unroll
  for (; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// Offsets of one (b, h, chunk c): element (b, t, h, x) of a (B, S, H, HD)
// tensor is base + t * row + x; entry (i, j) of chunk c's state in a
// (B, H, NC, HD, HD) buffer is state(c) + i * HD + j; row i of chunk c in a
// (B, H, NC, HD) buffer is vec(c) + i.
template <int HD>
struct Chunk {
  size_t base, row, bh;
  int c0, n, NC;
  __device__ Chunk(int S, int H) {
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    NC = gridDim.x;
    row = (size_t)H * HD;
    base = ((size_t)b * S * H + h) * HD;
    bh = (size_t)b * H + h;
    c0 = c * CK;
    n = min(CK, S - c0);
  }
  __device__ size_t at(int t) const { return base + (size_t)t * row; }
  __device__ size_t state(int c) const { return ((bh * NC + c) * HD) * HD; }
  __device__ size_t vec(int c) const { return (bh * NC + c) * HD; }
};

// The per-column kernels (phases 1 and 3) give each thread the four value
// columns j0 .. j0 + 3 over one quarter rq of the key rows (HD threads for
// a (b, h, chunk)), so each 16-byte read of a step's vector from shared
// memory feeds 16 state entries.  A step's vectors are stored with each
// quarter of the rows 4 floats further on than the last (pad), so the
// quarters' reads fall in different banks.  Lanes are ordered quarter by
// quarter (tid = rq HD / 4 + j0 / 4) unless the quarters' sums meet in a
// shuffle (tid = j0 + rq).
template <int HD>
struct Quads {
  static constexpr int NT = HD;             // threads
  static constexpr int HQ = HD / 4;         // rows a thread owns
  static constexpr int SP = HD + 16;        // padded stride of a staged step
  __device__ static int pad(int i) { return i + 4 * (i / HQ); }
  int rq, j0, roff;
  __device__ Quads(int tid, bool quarter_lanes)
      : rq(quarter_lanes ? tid & 3 : tid / HQ),
        j0(quarter_lanes ? tid & ~3 : (tid % HQ) * 4),
        roff((quarter_lanes ? tid & 3 : tid / HQ) * (HQ + 4)) {}
};

// Phase 1 of both directions, per (b, h, chunk): X = the recurrence
// X <- diag(w_t) X + a_t b_t^T over the chunk's steps from X = 0, in time
// order (forward: a = k, b = v, X = U_c) or in reverse (backward: a = r,
// b = dout, X = V_c); and D_c[i] = prod_t w_t[i].
template <typename T, int HD, bool REV>
__global__ void __launch_bounds__(Quads<HD>::NT)
wkv6_local_kernel(const T* __restrict__ a, const T* __restrict__ bv, const T* __restrict__ w,
                  float* __restrict__ buf, float* __restrict__ dbuf, int S, int H) {
  using P = Quads<HD>;
  constexpr int HQ = P::HQ;
  __shared__ __align__(16) float sa[TL][P::SP];
  __shared__ __align__(16) float sw[TL][P::SP];
  __shared__ __align__(16) float sb[TL][HD];
  const int tid = threadIdx.x, ptid = P::pad(tid);
  const P pr(tid, false);
  const Chunk<HD> ch(S, H);
  float x[HQ][4];  // X[rq * HQ + ii, j0 + cc]
#pragma unroll
  for (int ii = 0; ii < HQ; ++ii)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) x[ii][cc] = 0.f;
  float d = 1.f;  // D_c[tid]: thread tid keeps row tid's decay product
  const int ntile = (ch.n + TL - 1) / TL;
  for (int q = 0; q < ntile; ++q) {
    const int t0 = ch.c0 + (REV ? ntile - 1 - q : q) * TL;
    const int m = min(TL, ch.c0 + ch.n - t0);
    __syncthreads();  // the previous tile's reads are done
#pragma unroll 4
    for (int s = 0; s < m; ++s) {
      const size_t at = ch.at(t0 + s) + tid;
      sa[s][ptid] = to_f(a[at]);
      sw[s][ptid] = to_f(w[at]);
      sb[s][tid] = to_f(bv[at]);
    }
    __syncthreads();
    for (int e = 0; e < m; ++e) {
      const int s = REV ? m - 1 - e : e;
      const float4 b4 = *reinterpret_cast<const float4*>(&sb[s][pr.j0]);
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
      const float4* a4 = reinterpret_cast<const float4*>(sa[s] + pr.roff);
      const float4* w4 = reinterpret_cast<const float4*>(sw[s] + pr.roff);
#pragma unroll
      for (int i4 = 0; i4 < HQ / 4; ++i4) {
        const float4 av = a4[i4], wv = w4[i4];
        const float aa[4] = {av.x, av.y, av.z, av.w}, ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int q2 = 0; q2 < 4; ++q2)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            x[4 * i4 + q2][cc] = fmaf(x[4 * i4 + q2][cc], ww[q2], aa[q2] * bb[cc]);
      }
      d *= sw[s][ptid];
    }
  }
  float* dst = buf + ch.state(blockIdx.x) + (size_t)pr.rq * HQ * HD + pr.j0;
#pragma unroll
  for (int ii = 0; ii < HQ; ++ii)
    *reinterpret_cast<float4*>(dst + (size_t)ii * HD) =
        make_float4(x[ii][0], x[ii][1], x[ii][2], x[ii][3]);
  dbuf[ch.vec(blockIdx.x) + tid] = d;
}

// Phase 2 of both directions, one thread per state entry (b, h, i, j): over
// the chunks in order (forward) or in reverse (backward), replace each
// chunk's X_c in buf by the running value before it, and carry
// x <- D_c[i] * x + X_c; start from init (s0 / ds_last; null: 0), end in fin
// (s_last / ds0).
template <bool REV>
__global__ void __launch_bounds__(COMBINE_THREADS)
wkv6_combine_kernel(float* __restrict__ buf, const float* __restrict__ dbuf,
                    const float* __restrict__ init, float* __restrict__ fin, int NC, int HD,
                    size_t entries) {
  const size_t idx = (size_t)blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (idx >= entries) return;
  const size_t hd2 = (size_t)HD * HD, bh = idx / hd2, e = idx % hd2;
  float* p = buf + bh * NC * hd2 + e;
  const float* dp = dbuf + bh * NC * HD + e / HD;
  float st = init ? init[idx] : 0.f;
  for (int c0 = 0; c0 < NC; c0 += COMBINE_BATCH) {
    float xs[COMBINE_BATCH], ds[COMBINE_BATCH];
#pragma unroll
    for (int q = 0; q < COMBINE_BATCH; ++q) {
      const int c = REV ? NC - 1 - (c0 + q) : c0 + q;
      if (c0 + q < NC) {
        xs[q] = p[(size_t)c * hd2];
        ds[q] = dp[(size_t)c * HD];
      }
    }
#pragma unroll
    for (int q = 0; q < COMBINE_BATCH; ++q) {
      const int c = REV ? NC - 1 - (c0 + q) : c0 + q;
      if (c0 + q < NC) {
        p[(size_t)c * hd2] = st;
        st = fmaf(ds[q], st, xs[q]);
      }
    }
  }
  if (fin) fin[idx] = st;
}

// Phase 3 of the forward, per (b, h, chunk): the step recurrence from the
// chunk's start state ckpt[c], writing o.  Thread tid = j0 + rq holds
// columns j0 .. j0 + 3 over its quarter of the rows; the quarters' partial
// sums of o meet in a reduce-scatter over the 4 lanes (3 shuffles), after
// which lane rq owns column j0 + rq.
template <typename T, int HD>
__global__ void __launch_bounds__(Quads<HD>::NT)
wkv6_fwd_out_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ w, const float* __restrict__ u,
                    const float* __restrict__ ckpt, T* __restrict__ out, int S, int H) {
  using P = Quads<HD>;
  constexpr int HQ = P::HQ;
  __shared__ __align__(16) float sr[TL][P::SP];
  __shared__ __align__(16) float sk[TL][P::SP];
  __shared__ __align__(16) float sw[TL][P::SP];
  __shared__ __align__(16) float sv[TL][HD];
  __shared__ float su[HD], sruk[TL];
  const int tid = threadIdx.x, ptid = P::pad(tid);
  const P pr(tid, true);
  const bool h1 = pr.rq & 1, h2 = pr.rq & 2;
  const Chunk<HD> ch(S, H);
  su[tid] = u[blockIdx.y * HD + tid];
  float st[HQ][4];
  {
    const float* src = ckpt + ch.state(blockIdx.x) + (size_t)pr.rq * HQ * HD + pr.j0;
#pragma unroll
    for (int ii = 0; ii < HQ; ++ii) {
      const float4 x = *reinterpret_cast<const float4*>(src + (size_t)ii * HD);
      st[ii][0] = x.x; st[ii][1] = x.y; st[ii][2] = x.z; st[ii][3] = x.w;
    }
  }
  for (int t0 = ch.c0; t0 < ch.c0 + ch.n; t0 += TL) {
    const int m = min(TL, ch.c0 + ch.n - t0);
    __syncthreads();  // the previous tile's reads are done
#pragma unroll 4
    for (int s = 0; s < m; ++s) {
      const size_t at = ch.at(t0 + s) + tid;
      sr[s][ptid] = to_f(r[at]);
      sk[s][ptid] = to_f(k[at]);
      sw[s][ptid] = to_f(w[at]);
      sv[s][tid] = to_f(v[at]);
    }
    __syncthreads();
    if (tid < m) {  // thread s: r_s . (u * k_s), reading row s from a rotated start
      float ruk = 0.f;
      for (int c = 0; c < HD; ++c) {
        const int i = (c + tid) % HD, pi = P::pad(i);
        ruk = fmaf(sr[tid][pi] * su[i], sk[tid][pi], ruk);
      }
      sruk[tid] = ruk;
    }
    __syncthreads();
    for (int s = 0; s < m; ++s) {
      const float4 v4 = *reinterpret_cast<const float4*>(&sv[s][pr.j0]);
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
      const float4* r4 = reinterpret_cast<const float4*>(sr[s] + pr.roff);
      const float4* k4 = reinterpret_cast<const float4*>(sk[s] + pr.roff);
      const float4* w4 = reinterpret_cast<const float4*>(sw[s] + pr.roff);
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i4 = 0; i4 < HQ / 4; ++i4) {
        const float4 rv = r4[i4], kv = k4[i4], wv = w4[i4];
        const float rr[4] = {rv.x, rv.y, rv.z, rv.w}, kk[4] = {kv.x, kv.y, kv.z, kv.w},
                    ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int q2 = 0; q2 < 4; ++q2)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            float& sx = st[4 * i4 + q2][cc];
            o[cc] = fmaf(rr[q2], sx, o[cc]);
            sx = fmaf(sx, ww[q2], kk[q2] * vv[cc]);
          }
      }
      // the sum over the 4 lanes of the quarters: lane rq keeps column rq
      float o2[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float keep = h2 ? o[c + 2] : o[c], send = h2 ? o[c] : o[c + 2];
        o2[c] = keep + __shfl_xor_sync(FULL, send, 2);
      }
      const float oc = (h1 ? o2[1] : o2[0]) + __shfl_xor_sync(FULL, h1 ? o2[0] : o2[1], 1);
      const int j = pr.j0 + pr.rq;
      out[ch.at(t0 + s) + j] = from_f<T>(fmaf(sruk[s], sv[s][j], oc));
    }
  }
}

// The backward chunk kernel's shape (a thread owns RB adjacent rows of a
// warp's 8 columns; TS steps a sub-tile) and its shared memory, in floats.
template <int HD>
struct BwdChunk {
  static constexpr int JB = 8, TS = 4;
  static constexpr int RB = HD / 32;           // rows a thread owns
  static constexpr int NJ = HD / JB;           // column groups = warps
  static constexpr int NT = 32 * NJ;           // threads
  static constexpr int BND = 0;                // segment starts: [NSEG][NJ][RB][JB][32]
  static constexpr int SR = BND + NSEG * HD * HD;  // r, k, w, v, dout: [TL][HD]
  static constexpr int SK = SR + TL * HD;
  static constexpr int SW = SK + TL * HD;
  static constexpr int SV = SW + TL * HD;
  static constexpr int SDO = SV + TL * HD;
  static constexpr int SU = SDO + TL * HD;     // u: [HD]
  static constexpr int SVDO = SU + HD;         // v_t . do_t: [TL]
  static constexpr int SRUK = SVDO + TL;       // r_t . (u * k_t): [TL]
  static constexpr int RED = SRUK + TL;        // dr, dk, dw partials: [3][NJ][TS][HD]
  static constexpr int SDV = RED + 3 * NJ * TS * HD;  // dv without the u term: [TS][HD]
  static constexpr int SDU = SDV + TS * HD;    // du's partial a thread keeps: [NT]
  static constexpr int FLOATS = SDU + NT;
};

template <int RB>
__device__ __forceinline__ void load_rows(const float* p, float (&out)[RB]) {
  if constexpr (RB == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x;
    out[1] = x.y;
  } else {
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) out[rr] = p[rr];
  }
}
__device__ __forceinline__ void load8(const float* p, float (&out)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// Phase 3 of the backward, per (b, h, chunk).  Thread tid owns rows
// i0 .. i0 + RB - 1, i0 = (tid % 32) RB, and columns j0 .. j0 + 7,
// j0 = (tid / 32) 8, of S and G.
template <typename T, int HD>
__global__ void __launch_bounds__(BwdChunk<HD>::NT, 2)
wkv6_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ w, const float* __restrict__ u,
                      const float* __restrict__ ckpt, const float* __restrict__ gend,
                      const T* __restrict__ dout, T* __restrict__ dr, T* __restrict__ dk,
                      T* __restrict__ dv, T* __restrict__ dw, float* __restrict__ du_part,
                      int S, int H) {
  using L = BwdChunk<HD>;
  constexpr int JB = L::JB, TS = L::TS, RB = L::RB, NJ = L::NJ, NT = L::NT;
  extern __shared__ __align__(16) float smem[];
  float* bnd = smem + L::BND;
  float* sr = smem + L::SR;
  float* sk = smem + L::SK;
  float* sw = smem + L::SW;
  float* sv = smem + L::SV;
  float* sdo = smem + L::SDO;
  float* su = smem + L::SU;
  float* svdo = smem + L::SVDO;
  float* sruk = smem + L::SRUK;
  float* red = smem + L::RED;
  float* sdv = smem + L::SDV;
  float* sdu = smem + L::SDU;

  const int tid = threadIdx.x, lane = tid & 31, jg = tid >> 5, j0 = jg * JB, i0 = lane * RB;
  const Chunk<HD> ch(S, H);
  const int c = blockIdx.x, h = blockIdx.y, nseg = (ch.n + TL - 1) / TL;
  if (tid < HD) su[tid] = u[h * HD + tid];
  auto bnd_at = [&](int q, int rr, int jj) {
    return bnd + (((q * NJ + jg) * RB + rr) * JB + jj) * 32 + lane;
  };
  auto src_of = [&](int a) { return a == 0 ? k : a == 1 ? w : a == 2 ? v : a == 3 ? r : dout; };
  auto dst_of = [&](int a) { return a == 0 ? sk : a == 1 ? sw : a == 2 ? sv : a == 3 ? sr : sdo; };
  // rows [t0, t0 + m) of the first na of k, w, v, r, dout into the step
  // buffers as float32; every load is issued before the first store
  auto stage = [&](int na, int t0, int m) {
    constexpr int E = TL * HD / NT;
    float val[5][E];
#pragma unroll
    for (int a = 0; a < 5; ++a)
#pragma unroll
      for (int e2 = 0; e2 < E; ++e2) {
        const int e = tid + e2 * NT;
        val[a][e2] = (a < na && e < m * HD) ? to_f(src_of(a)[ch.at(t0 + e / HD) + e % HD]) : 0.f;
      }
#pragma unroll
    for (int a = 0; a < 5; ++a)
#pragma unroll
      for (int e2 = 0; e2 < E; ++e2)
        if (a < na) dst_of(a)[tid + e2 * NT] = val[a][e2];
  };
  auto step = [&](float (&st)[RB][JB], int s) {
    float kr[RB], wr[RB], vv[JB];
    load_rows<RB>(sk + s * HD + i0, kr);
    load_rows<RB>(sw + s * HD + i0, wr);
    load8(sv + s * HD + j0, vv);
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) st[rr][jj] = fmaf(st[rr][jj], wr[rr], kr[rr] * vv[jj]);
  };

  // 1. the state at each segment's start, from the chunk's checkpoint
  float st[RB][JB], g[RB][JB];
#pragma unroll
  for (int rr = 0; rr < RB; ++rr) {
    load8(ckpt + ch.state(c) + (size_t)(i0 + rr) * HD + j0, st[rr]);
    load8(gend + ch.state(c) + (size_t)(i0 + rr) * HD + j0, g[rr]);  // G_end(c)
  }
  for (int q = 0; q < nseg; ++q) {
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) *bnd_at(q, rr, jj) = st[rr][jj];
    if (q + 1 == nseg) break;  // uniform over the CTA; segments before the last are full
    __syncthreads();
    stage(3, ch.c0 + q * TL, TL);
    __syncthreads();
    for (int s = 0; s < TL; ++s) step(st, s);
  }

  // 2. the segments from the last, each in sub-tiles of TS steps from the last.
  // The sub-tile's outputs are summed by thread tid for step tid / HD and row
  // or column tid % HD (NT = TS HD); it also keeps du's partial for row
  // tid % HD over the steps tid / HD of every sub-tile.
  static_assert(NT == TS * HD, "one finalizing thread per (step, row) of a sub-tile");
  sdu[tid] = 0.f;
  for (int q = nseg - 1; q >= 0; --q) {
    const int t0 = ch.c0 + q * TL, m = min(TL, ch.c0 + ch.n - t0);
    __syncthreads();  // earlier reads of the step buffers are done
    stage(5, t0, m);
    __syncthreads();
    for (int s = jg; s < m; s += NJ) {  // warp s: v_s . do_s and r_s . (u * k_s)
      float vdo = 0.f, ruk = 0.f;
#pragma unroll
      for (int x = lane; x < HD; x += 32) {
        vdo = fmaf(sv[s * HD + x], sdo[s * HD + x], vdo);
        ruk = fmaf(sr[s * HD + x] * su[x], sk[s * HD + x], ruk);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        vdo += __shfl_xor_sync(FULL, vdo, off);
        ruk += __shfl_xor_sync(FULL, ruk, off);
      }
      if (lane == 0) {
        svdo[s] = vdo;
        sruk[s] = ruk;
      }
    }
    __syncthreads();
    for (int p = (m - 1) / TS; p >= 0; --p) {
      const int s0 = p * TS, mm = min(TS, m - s0);
      // S_{t-1} of the sub-tile's steps, rebuilt from the segment's start
#pragma unroll
      for (int rr = 0; rr < RB; ++rr)
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) st[rr][jj] = *bnd_at(q, rr, jj);
      for (int s = 0; s < s0; ++s) step(st, s);
      // the states before the sub-tile's steps: hist[s2] for s2 < mm - 1, and
      // the last in st
      auto sub_tile = [&](auto full) {
        constexpr bool FULL_TILE = decltype(full)::value;
        float hist[TS - 1][RB][JB];
#pragma unroll
        for (int s2 = 0; s2 + 1 < TS; ++s2) {
          if (FULL_TILE || s2 + 1 < mm) {
#pragma unroll
            for (int rr = 0; rr < RB; ++rr)
#pragma unroll
              for (int jj = 0; jj < JB; ++jj) hist[s2][rr][jj] = st[rr][jj];
            step(st, s0 + s2);
          }
        }
#pragma unroll
        for (int s2 = TS - 1; s2 >= 0; --s2) {
          if (FULL_TILE || s2 < mm) {
            const int s = s0 + s2;
            float rv[RB], kr[RB], wr[RB], vv[JB], dd[JB];
            load_rows<RB>(sr + s * HD + i0, rv);
            load_rows<RB>(sk + s * HD + i0, kr);
            load_rows<RB>(sw + s * HD + i0, wr);
            load8(sv + s * HD + j0, vv);
            load8(sdo + s * HD + j0, dd);
            float dr_a[RB], dk_a[RB], dw_a[RB], dvp[JB];
#pragma unroll
            for (int jj = 0; jj < JB; ++jj) dvp[jj] = 0.f;
#pragma unroll
            for (int rr = 0; rr < RB; ++rr) {
              dr_a[rr] = dk_a[rr] = dw_a[rr] = 0.f;
#pragma unroll
              for (int jj = 0; jj < JB; ++jj) {
                const bool last = FULL_TILE ? s2 == TS - 1 : s2 == mm - 1;
                const float sp = last ? st[rr][jj] : hist[s2 < TS - 1 ? s2 : 0][rr][jj];
                const float gg = g[rr][jj];
                dr_a[rr] = fmaf(sp, dd[jj], dr_a[rr]);
                dk_a[rr] = fmaf(gg, vv[jj], dk_a[rr]);
                dw_a[rr] = fmaf(gg, sp, dw_a[rr]);
                dvp[jj] = fmaf(gg, kr[rr], dvp[jj]);
                g[rr][jj] = fmaf(gg, wr[rr], rv[rr] * dd[jj]);  // G_{t-1} = w_t G_t + r_t do_t^T
              }
            }
#pragma unroll
            for (int rr = 0; rr < RB; ++rr) {
              red[((0 * NJ + jg) * TS + s2) * HD + i0 + rr] = dr_a[rr];
              red[((1 * NJ + jg) * TS + s2) * HD + i0 + rr] = dk_a[rr];
              red[((2 * NJ + jg) * TS + s2) * HD + i0 + rr] = dw_a[rr];
            }
            // dv over all HD rows: RB in the thread, 32 lanes in the warp
            const float dvs = reduce_scatter<JB>(dvp, lane);
            if (lane % (32 / JB) == 0) sdv[s2 * HD + j0 + lane / (32 / JB)] = dvs;
          }
        }
      };
      if (mm == TS)
        sub_tile(std::true_type{});
      else
        sub_tile(std::false_type{});
      __syncthreads();
      // the sub-tile's outputs: dr, dk, dw summed over the column groups in a
      // fixed order, dv with its u term
      if (tid < mm * HD) {
        const int s2 = tid / HD, x = tid % HD, s = s0 + s2;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll
        for (int q2 = 0; q2 < NJ; ++q2) {
          a0 += red[((0 * NJ + q2) * TS + s2) * HD + x];
          a1 += red[((1 * NJ + q2) * TS + s2) * HD + x];
          a2 += red[((2 * NJ + q2) * TS + s2) * HD + x];
        }
        const float vdo = svdo[s], ux = su[x], rx = sr[s * HD + x], kx = sk[s * HD + x];
        const size_t at = ch.at(t0 + s) + x;
        dr[at] = from_f<T>(fmaf(ux * kx, vdo, a0));
        dk[at] = from_f<T>(fmaf(ux * rx, vdo, a1));
        dw[at] = from_f<T>(a2);
        dv[at] = from_f<T>(fmaf(sruk[s], sdo[s * HD + x], sdv[s2 * HD + x]));
        sdu[tid] = fmaf(rx * kx, vdo, sdu[tid]);
      }
      __syncthreads();  // red and sdv are free again
    }
  }
  // du's partial for this chunk: the TS partials of each row, in order
  __syncthreads();
  if (tid < HD) {
    float du = 0.f;
#pragma unroll
    for (int q2 = 0; q2 < TS; ++q2) du += sdu[q2 * HD + tid];
    du_part[(((size_t)blockIdx.z * ch.NC + c) * H + h) * HD + tid] = du;
  }
}

template <typename T, int HD>
cudaError_t launch_fwd(const void* r, const void* k, const void* v, const void* w,
                       const float* u, const float* s0, void* out, float* s_last, float* ckpt,
                       float* dbuf, int B, int S, int H, cudaStream_t st) {
  const int NC = (S + CK - 1) / CK;
  const dim3 grid(NC, H, B);
  wkv6_local_kernel<T, HD, false><<<grid, Quads<HD>::NT, 0, st>>>((const T*)k, (const T*)v,
                                                                 (const T*)w, ckpt, dbuf, S, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t entries = (size_t)B * H * HD * HD;
  wkv6_combine_kernel<false><<<(unsigned)((entries + COMBINE_THREADS - 1) / COMBINE_THREADS),
                               COMBINE_THREADS, 0, st>>>(ckpt, dbuf, s0, s_last, NC, HD, entries);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wkv6_fwd_out_kernel<T, HD><<<grid, Quads<HD>::NT, 0, st>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, u, ckpt, (T*)out, S, H);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_chunk(const void* r, const void* k, const void* v, const void* w,
                         const float* u, const float* ckpt, const float* gbuf, const void* dout,
                         void* dr, void* dk, void* dv, void* dw, float* du_part, dim3 grid,
                         int S, int H, cudaStream_t st) {
  using L = BwdChunk<HD>;
  const int smem = L::FLOATS * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(wkv6_bwd_chunk_kernel<T, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  wkv6_bwd_chunk_kernel<T, HD><<<grid, L::NT, smem, st>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, u, ckpt, gbuf, (const T*)dout,
      (T*)dr, (T*)dk, (T*)dv, (T*)dw, du_part, S, H);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* r, const void* k, const void* v, const void* w,
                       const float* u, const float* ckpt, const void* dout,
                       const float* ds_last, void* dr, void* dk, void* dv, void* dw,
                       float* du_part, float* ds0, float* gbuf, float* dbuf, int B, int S,
                       int H, cudaStream_t st) {
  const int NC = (S + CK - 1) / CK;
  const dim3 grid(NC, H, B);
  wkv6_local_kernel<T, HD, true><<<grid, Quads<HD>::NT, 0, st>>>((const T*)r, (const T*)dout,
                                                                (const T*)w, gbuf, dbuf, S, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t entries = (size_t)B * H * HD * HD;
  wkv6_combine_kernel<true><<<(unsigned)((entries + COMBINE_THREADS - 1) / COMBINE_THREADS),
                              COMBINE_THREADS, 0, st>>>(gbuf, dbuf, ds_last, ds0, NC, HD,
                                                        entries);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_chunk<T, HD>(r, k, v, w, u, ckpt, gbuf, dout, dr, dk, dv, dw, du_part, grid, S,
                            H, st);
}

// out = {registers a thread, shared bytes (static + dynamic), threads, CTAs per SM}
template <typename K>
cudaError_t occupancy(K kern, int dyn_smem, int threads, int* out) {
  cudaError_t e = cudaSuccess;
  if (dyn_smem > 0)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn_smem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kern);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kern, threads, dyn_smem);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes + dyn_smem;
  out[2] = threads;
  return cudaSuccess;
}

// which: 0 local (forward), 1 local (backward), 2 combine, 3 forward output,
// 4 backward chunk; the bfloat16 instantiations
template <int HD>
cudaError_t occupancy_of(int which, int* out) {
  using T = __nv_bfloat16;
  switch (which) {
    case 0: return occupancy(wkv6_local_kernel<T, HD, false>, 0, Quads<HD>::NT, out);
    case 1: return occupancy(wkv6_local_kernel<T, HD, true>, 0, Quads<HD>::NT, out);
    case 2: return occupancy(wkv6_combine_kernel<false>, 0, COMBINE_THREADS, out);
    case 3: return occupancy(wkv6_fwd_out_kernel<T, HD>, 0, Quads<HD>::NT, out);
    case 4:
      return occupancy(wkv6_bwd_chunk_kernel<T, HD>, BwdChunk<HD>::FLOATS * (int)sizeof(float),
                       BwdChunk<HD>::NT, out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; hd: 32 or 64.  s0 may be null (zeros in);
// ckpt (B, H, NC, hd, hd) and dbuf (B, H, NC, hd) are always written (the
// chunk-start states and decay products).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
                        const float* u, const float* s0, void* out, float* s_last,
                        float* ckpt, float* dbuf, int B, int S, int H, int hd, int dtype,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && hd == 64)
    return launch_fwd<float, 64>(r, k, v, w, u, s0, out, s_last, ckpt, dbuf, B, S, H, st);
  if (dtype == 0 && hd == 32)
    return launch_fwd<float, 32>(r, k, v, w, u, s0, out, s_last, ckpt, dbuf, B, S, H, st);
  if (dtype == 1 && hd == 64)
    return launch_fwd<__nv_bfloat16, 64>(r, k, v, w, u, s0, out, s_last, ckpt, dbuf, B, S, H,
                                         st);
  if (dtype == 1 && hd == 32)
    return launch_fwd<__nv_bfloat16, 32>(r, k, v, w, u, s0, out, s_last, ckpt, dbuf, B, S, H,
                                         st);
  return (int)cudaErrorInvalidValue;
}

// ds_last may be null (zeros in).  gbuf (B, H, NC, hd, hd) and dbuf
// (B, H, NC, hd) are scratch.
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                        const float* u, const float* ckpt, const void* dout,
                        const float* ds_last, void* dr, void* dk, void* dv, void* dw,
                        float* du_part, float* ds0, float* gbuf, float* dbuf, int B, int S,
                        int H, int hd, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define WKV6_BWD(T, HD)                                                                  \
  return launch_bwd<T, HD>(r, k, v, w, u, ckpt, dout, ds_last, dr, dk, dv, dw, du_part, \
                           ds0, gbuf, dbuf, B, S, H, st)
  if (dtype == 0 && hd == 64) WKV6_BWD(float, 64);
  if (dtype == 0 && hd == 32) WKV6_BWD(float, 32);
  if (dtype == 1 && hd == 64) WKV6_BWD(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 32) WKV6_BWD(__nv_bfloat16, 32);
#undef WKV6_BWD
  return (int)cudaErrorInvalidValue;
}

// The resources of one kernel (which: 0 local forward, 1 local backward, 2
// combine, 3 forward output, 4 backward chunk; bfloat16) at head dim hd:
// out = {registers a thread, shared bytes, threads, CTAs per SM}.
extern "C" int wkv6_occupancy(int which, int hd, int* out) {
  if (hd == 64) return (int)occupancy_of<64>(which, out);
  if (hd == 32) return (int)occupancy_of<32>(which, out);
  return (int)cudaErrorInvalidValue;
}
