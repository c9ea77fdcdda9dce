// RWKV6 (Finch) wkv scan, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py::_wkv6_kernel (the
// Pallas forward); the backward kernel has no TPU counterpart (its
// reference is jax.grad of repro.kernels.ref.wkv6).
//
// Per (b, h), with the state S in R^{hd x hd} (row i = key channel,
// column j = value channel), every step in float32:
//
//   o_t[j]    = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] * k_t[i] * v_t[j])
//   S_t[i,j]  = w_t[i] * S_{t-1}[i,j] + k_t[i] * v_t[j]
//
// This is the reference's step recurrence (repro.kernels.ref.wkv6), not the
// Pallas kernel's chunked log-decay form: k * exp(-cumsum(log w)) overflows
// float32 once the decay over a 64-token block passes e^-88, and the step
// form is exact at any decay.
//
// Layout: r, k, v, w, out, dout, dv (B, S, H, hd) contiguous, float32 or
// bfloat16 (one dtype for all); u (H, hd) float32; s0, s_last, ds_last, ds0
// (B, H, hd, hd) float32; ckpt (B, H, NC, hd, hd) float32 with NC =
// ceil(S / 64): the state before steps 0, 64, 128, ...; dr_part, dk_part,
// dw_part (NJ, B, S, H, hd) float32 and du_part (NJ, B, H, hd) float32, one
// partial per block of value columns (NJ = hd / 16), summed by the caller.
// hd is 32 or 64.
//
// What bounds it on this card: at the main path's shape (B 2, S 1024, H 32,
// hd 64, bf16) the forward moves ~60 MB (r, k, v, w, out, the checkpoints)
// but needs ~5 float32 operations per state entry and step, 1.36 GFLOP, so
// the CUDA cores' float32 rate bounds it (~20 us; this kernel does 7, as it
// adds the u bonus per entry, not as one (r . (u * k)) v_t per step); the
// backward likewise (~14 operations per entry and step). There are only B * H = 64 heads,
// each a 1024-step dependent chain. The design:
//   * the value columns of S are independent (S[:, j] depends only on
//     v[:, j]), so a CTA owns one block of 16 columns of one head: 4 CTAs per
//     head, 256 at the main path's shape;
//   * one thread per key channel i (hd threads) holds S[i, j0:j0+16] in
//     registers, so the state update and the row sums the backward needs
//     (dr, dk, dw over j) stay in the thread; the column sums over i (o
//     forward, dv backward) are a warp reduce-scatter of 16 values (16
//     shuffles, reduce_scatter16), and across the two warps at hd 64 a sum
//     in shared memory once per tile of 16 steps;
//   * r, k, w, v (and dout) of a tile of 16 steps are staged in shared
//     memory with coalesced loads.
// The backward needs S_{t-1} and the state cotangent G_t at the same t while
// it walks time in reverse. Dividing by w (S_{t-1} = (S_t - k v^T) / w)
// fails as w -> 0, and saving every state would cost (B, H, S, hd, hd)
// float32 (1 GB a layer at the main path's shape). So the forward saves a
// checkpoint every 64 steps (16.8 MB a layer), and the backward, chunk by
// chunk from the last, rebuilds the state at each 16-step tile's start from
// the checkpoint, then for each tile from the last rebuilds its 16 states
// S_{t-1} into shared memory (each thread its own entries) and walks them in
// reverse. It never divides by w. The sums over j of dr, dk, dw and du are
// partials of this CTA's 16 columns, written per column block and reduced
// by the caller's sum(0): no atomics, deterministic.
//
// Every entry point launches on the stream it is given and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int JB = 16;   // value columns per CTA
constexpr int TL = 16;   // time steps per tile staged in shared memory
constexpr int CK = 64;   // checkpoint interval of the forward (steps)
constexpr int NSUB = CK / TL;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The sum over the warp's 32 lanes of v[c] for c = lane >> 1 (lanes 2c and
// 2c + 1 both return it): each level halves the values a lane keeps and
// adds its partner's half, 8 + 4 + 2 + 1 + 1 shuffles.
__device__ __forceinline__ float reduce_scatter16(const float (&v)[JB], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float a8[8], a4[4], a2[2];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float keep = b4 ? v[c + 8] : v[c], send = b4 ? v[c] : v[c + 8];
    a8[c] = keep + __shfl_xor_sync(FULL, send, 16);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float keep = b3 ? a8[c + 4] : a8[c], send = b3 ? a8[c] : a8[c + 4];
    a4[c] = keep + __shfl_xor_sync(FULL, send, 8);
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float keep = b2 ? a4[c + 2] : a4[c], send = b2 ? a4[c] : a4[c + 2];
    a2[c] = keep + __shfl_xor_sync(FULL, send, 4);
  }
  float a1 = (b1 ? a2[1] : a2[0]) + __shfl_xor_sync(FULL, b1 ? a2[0] : a2[1], 2);
  return a1 + __shfl_xor_sync(FULL, a1, 1);
}

// Offsets: element (b, t, h, c) of a (B, S, H, HD) tensor is
// base + t * row + c with base = ((b * S) * H + h) * HD and row = H * HD;
// entry (b, h, i, j0 + jj) of a (B, H, HD, HD) state is sbase + jj.
template <int HD>
struct Index {
  size_t base, row, sbase, ckbase;
  int j0, NC;
  __device__ Index(int b, int h, int jb, int i, int S, int H) {
    row = (size_t)H * HD;
    base = ((size_t)b * S * H + h) * HD;
    j0 = jb * JB;
    sbase = (((size_t)b * H + h) * HD + i) * HD + j0;
    NC = (S + CK - 1) / CK;
    ckbase = ((((size_t)b * H + h) * NC) * HD + i) * HD + j0;  // chunk 0
  }
  // entry (b, h, c, i, j0) of the (B, H, NC, HD, HD) checkpoints
  __device__ size_t ck(int c) const { return ckbase + (size_t)c * HD * HD; }
};

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ s0, T* __restrict__ out,
                float* __restrict__ s_last, float* __restrict__ ckpt, int S, int H) {
  constexpr int NW = HD / 32;
  __shared__ float sr[TL][HD], sk[TL][HD], sw[TL][HD], sv[TL][JB], so[NW][TL][JB];
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const Index<HD> ix(b, h, blockIdx.x, i, S, H);
  const float ui = u[h * HD + i];
  float st[JB];
#pragma unroll
  for (int jj = 0; jj < JB; ++jj) st[jj] = s0 ? s0[ix.sbase + jj] : 0.f;

  for (int t0 = 0; t0 < S; t0 += TL) {
    const int n = min(TL, S - t0);
    if (ckpt && t0 % CK == 0) {
      float* dst = ckpt + ix.ck(t0 / CK);
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) dst[jj] = st[jj];
    }
    __syncthreads();  // the previous tile's reads of so are done
    for (int s = 0; s < n; ++s) {
      const size_t at = ix.base + (size_t)(t0 + s) * ix.row + i;
      sr[s][i] = to_f(r[at]);
      sk[s][i] = to_f(k[at]);
      sw[s][i] = to_f(w[at]);
    }
    for (int e = i; e < n * JB; e += HD)
      sv[e / JB][e % JB] = to_f(v[ix.base + (size_t)(t0 + e / JB) * ix.row + ix.j0 + e % JB]);
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const float ri = sr[s][i], ki = sk[s][i], wi = sw[s][i], uki = ui * ki;
      float part[JB];
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) {
        const float vj = sv[s][jj];
        part[jj] = ri * fmaf(uki, vj, st[jj]);  // r_i (S_{t-1} + u_i k_i v_j)
        st[jj] = fmaf(st[jj], wi, ki * vj);
      }
      const float o = reduce_scatter16(part, lane);
      if ((lane & 1) == 0) so[warp][s][lane >> 1] = o;
    }
    __syncthreads();
    for (int e = i; e < n * JB; e += HD) {
      const int s = e / JB, jj = e % JB;
      float o = 0.f;
#pragma unroll
      for (int q = 0; q < NW; ++q) o += so[q][s][jj];
      out[ix.base + (size_t)(t0 + s) * ix.row + ix.j0 + jj] = from_f<T>(o);
    }
  }
  if (s_last) {
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) s_last[ix.sbase + jj] = st[jj];
  }
}

// Dynamic shared memory of the backward, in floats.
template <int HD>
constexpr int bwd_smem_floats() {
  return NSUB * JB * HD      // bnd: the state at each tile's start in a chunk
         + TL * JB * HD      // hist: S_{t-1} of each step of a tile
         + 3 * TL * HD       // r, k, w of a tile
         + 2 * TL * JB       // v, dout of a tile (this block's columns)
         + 2 * TL            // v . dout (this block's columns), sum_i r u k
         + (HD / 32) * TL * JB;  // per-warp column sums of dv
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ ckpt, const T* __restrict__ dout,
                const float* __restrict__ ds_last, float* __restrict__ dr_part,
                float* __restrict__ dk_part, float* __restrict__ dw_part, T* __restrict__ dv,
                float* __restrict__ du_part, float* __restrict__ ds0, int S, int H) {
  constexpr int NW = HD / 32;
  extern __shared__ float smem[];
  // Per-thread regions (bnd, hist) are laid out [..][jj][i], so a warp's
  // accesses at one (.., jj) are 32 consecutive floats.
  float* bnd = smem;
  float* hist = bnd + NSUB * JB * HD;
  float* sr = hist + TL * JB * HD;
  float* sk = sr + TL * HD;
  float* sw = sk + TL * HD;
  float* sv = sw + TL * HD;
  float* sdo = sv + TL * JB;
  float* svdo = sdo + TL * JB;
  float* sruk = svdo + TL;
  float* sdv = sruk + TL;

  const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const int jb = blockIdx.x, h = blockIdx.y, b = blockIdx.z, B = gridDim.z;
  const Index<HD> ix(b, h, jb, i, S, H);
  const size_t poff = (size_t)jb * B * S * H * HD;  // this column block's partials
  const float ui = u[h * HD + i];
  float g[JB];  // G_t[i, j0 + jj], the cotangent of S_t
#pragma unroll
  for (int jj = 0; jj < JB; ++jj) g[jj] = ds_last ? ds_last[ix.sbase + jj] : 0.f;
  float du_acc = 0.f;

  for (int c = ix.NC - 1; c >= 0; --c) {
    const int c0 = c * CK, nsub = (min(CK, S - c0) + TL - 1) / TL;
    // 1. the state at each tile's start, from the chunk's checkpoint
    float st[JB];
    const float* src = ckpt + ix.ck(c);
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) st[jj] = src[jj];
    for (int q = 0; q < nsub; ++q) {
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) bnd[(q * JB + jj) * HD + i] = st[jj];
      if (q + 1 == nsub) break;  // uniform over the CTA; tiles before the last are full
      const int t0 = c0 + q * TL;
      __syncthreads();
      for (int s = 0; s < TL; ++s) {
        const size_t at = ix.base + (size_t)(t0 + s) * ix.row + i;
        sk[s * HD + i] = to_f(k[at]);
        sw[s * HD + i] = to_f(w[at]);
      }
      for (int e = i; e < TL * JB; e += HD)
        sv[e] = to_f(v[ix.base + (size_t)(t0 + e / JB) * ix.row + ix.j0 + e % JB]);
      __syncthreads();
      for (int s = 0; s < TL; ++s) {
        const float ki = sk[s * HD + i], wi = sw[s * HD + i];
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) st[jj] = fmaf(st[jj], wi, ki * sv[s * JB + jj]);
      }
    }
    // 2. the chunk's tiles from the last
    for (int q = nsub - 1; q >= 0; --q) {
      const int t0 = c0 + q * TL, n = min(TL, S - t0);
      __syncthreads();  // earlier reads of the tile buffers are done
      for (int s = 0; s < n; ++s) {
        const size_t at = ix.base + (size_t)(t0 + s) * ix.row + i;
        sr[s * HD + i] = to_f(r[at]);
        sk[s * HD + i] = to_f(k[at]);
        sw[s * HD + i] = to_f(w[at]);
      }
      for (int e = i; e < n * JB; e += HD) {
        const size_t at = ix.base + (size_t)(t0 + e / JB) * ix.row + ix.j0 + e % JB;
        sv[e] = to_f(v[at]);
        sdo[e] = to_f(dout[at]);
      }
      __syncthreads();
      if (i < n) {  // thread s sums step s (n <= TL <= HD)
        float vdo = 0.f, ruk = 0.f;
        for (int jj = 0; jj < JB; ++jj) vdo = fmaf(sv[i * JB + jj], sdo[i * JB + jj], vdo);
        for (int c2 = 0; c2 < HD; ++c2)
          ruk = fmaf(sr[i * HD + c2] * u[h * HD + c2], sk[i * HD + c2], ruk);
        svdo[i] = vdo;
        sruk[i] = ruk;
      }
      __syncthreads();
      // S_{t-1} of every step of the tile, from the tile's start
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) st[jj] = bnd[(q * JB + jj) * HD + i];
      for (int s = 0; s < n; ++s) {
        const float ki = sk[s * HD + i], wi = sw[s * HD + i];
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          hist[(s * JB + jj) * HD + i] = st[jj];
          st[jj] = fmaf(st[jj], wi, ki * sv[s * JB + jj]);
        }
      }
      // the reverse walk: g holds G_t on entry to step t
      for (int s = n - 1; s >= 0; --s) {
        const float ri = sr[s * HD + i], ki = sk[s * HD + i], wi = sw[s * HD + i];
        const float vdo = svdo[s];
        float dr_a = 0.f, dk_a = 0.f, dw_a = 0.f, dvp[JB];
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          const float sp = hist[(s * JB + jj) * HD + i];
          const float vj = sv[s * JB + jj], doj = sdo[s * JB + jj];
          dr_a = fmaf(sp, doj, dr_a);
          dk_a = fmaf(g[jj], vj, dk_a);
          dw_a = fmaf(g[jj], sp, dw_a);
          dvp[jj] = g[jj] * ki;
          g[jj] = fmaf(g[jj], wi, ri * doj);  // G_{t-1} = w_t G_t + r_t do_t^T
        }
        const size_t at = poff + ix.base + (size_t)(t0 + s) * ix.row + i;
        dr_part[at] = fmaf(ui * ki, vdo, dr_a);
        dk_part[at] = fmaf(ui * ri, vdo, dk_a);
        dw_part[at] = dw_a;
        du_acc = fmaf(ri * ki, vdo, du_acc);
        const float dvs = reduce_scatter16(dvp, lane);
        if ((lane & 1) == 0) sdv[(warp * TL + s) * JB + (lane >> 1)] = dvs;
      }
      __syncthreads();
      for (int e = i; e < n * JB; e += HD) {
        const int s = e / JB, jj = e % JB;
        float a = sruk[s] * sdo[e];  // (sum_i r u k) do_t[j]
#pragma unroll
        for (int q2 = 0; q2 < NW; ++q2) a += sdv[(q2 * TL + s) * JB + jj];
        dv[ix.base + (size_t)(t0 + s) * ix.row + ix.j0 + jj] = from_f<T>(a);
      }
    }
  }
  du_part[(((size_t)jb * B + b) * H + h) * HD + i] = du_acc;
  if (ds0) {
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) ds0[ix.sbase + jj] = g[jj];
  }
}

template <typename T, int HD>
int launch_fwd(const void* r, const void* k, const void* v, const void* w, const float* u,
               const float* s0, void* out, float* s_last, float* ckpt, int B, int S, int H,
               cudaStream_t st) {
  wkv6_fwd_kernel<T, HD><<<dim3(HD / JB, H, B), HD, 0, st>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, u, s0, (T*)out, s_last, ckpt, S, H);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_bwd(const void* r, const void* k, const void* v, const void* w, const float* u,
               const float* ckpt, const void* dout, const float* ds_last, float* dr_part,
               float* dk_part, float* dw_part, void* dv, float* du_part, float* ds0, int B,
               int S, int H, cudaStream_t st) {
  const int smem = bwd_smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(wkv6_bwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_kernel<T, HD><<<dim3(HD / JB, H, B), HD, smem, st>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, u, ckpt, (const T*)dout, ds_last,
      dr_part, dk_part, dw_part, (T*)dv, du_part, ds0, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; hd: 32 or 64.  s0, s_last and ckpt may be
// null (zeros in; not written).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
                        const float* u, const float* s0, void* out, float* s_last,
                        float* ckpt, int B, int S, int H, int hd, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && hd == 64)
    return launch_fwd<float, 64>(r, k, v, w, u, s0, out, s_last, ckpt, B, S, H, st);
  if (dtype == 0 && hd == 32)
    return launch_fwd<float, 32>(r, k, v, w, u, s0, out, s_last, ckpt, B, S, H, st);
  if (dtype == 1 && hd == 64)
    return launch_fwd<__nv_bfloat16, 64>(r, k, v, w, u, s0, out, s_last, ckpt, B, S, H, st);
  if (dtype == 1 && hd == 32)
    return launch_fwd<__nv_bfloat16, 32>(r, k, v, w, u, s0, out, s_last, ckpt, B, S, H, st);
  return (int)cudaErrorInvalidValue;
}

// ds_last and ds0 may be null (zeros in; ds0 not written).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                        const float* u, const float* ckpt, const void* dout,
                        const float* ds_last, float* dr_part, float* dk_part, float* dw_part,
                        void* dv, float* du_part, float* ds0, int B, int S, int H, int hd,
                        int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && hd == 64)
    return launch_bwd<float, 64>(r, k, v, w, u, ckpt, dout, ds_last, dr_part, dk_part,
                                 dw_part, dv, du_part, ds0, B, S, H, st);
  if (dtype == 0 && hd == 32)
    return launch_bwd<float, 32>(r, k, v, w, u, ckpt, dout, ds_last, dr_part, dk_part,
                                 dw_part, dv, du_part, ds0, B, S, H, st);
  if (dtype == 1 && hd == 64)
    return launch_bwd<__nv_bfloat16, 64>(r, k, v, w, u, ckpt, dout, ds_last, dr_part, dk_part,
                                         dw_part, dv, du_part, ds0, B, S, H, st);
  if (dtype == 1 && hd == 32)
    return launch_bwd<__nv_bfloat16, 32>(r, k, v, w, u, ckpt, dout, ds_last, dr_part, dk_part,
                                         dw_part, dv, du_part, ds0, B, S, H, st);
  return (int)cudaErrorInvalidValue;
}
