// K-rms: the models' RMSNorm (models/llama._rmsnorm, which models/afmoe
// calls too) on Hopper (sm_90a) as two kernels and a finishing pass, through
// kernels/rmsnorm.py:
//
//   rms_fwd_kernel<BF16, VPT>:  per row, rstd = rsqrt(sum(x^2) / D + eps) and
//                               y = T((x * rstd) * scale), rstd kept (4 bytes
//                               a row) for the backward;
//   rms_bwd_kernel<BF16, VPT>:  per row, x^ = x * rstd, g = dy * scale and
//                               dx = T(rstd * (g - x^ * sum(g * x^) / D)); per
//                               column, sum over the CTA's rows of dy * x^ as
//                               one f32 partial a CTA;
//   rms_bwd_finish_kernel:      dscale = the CTAs' partials added in CTA order.
//
// They replace no Pallas kernel: the JAX models' RMSNorm is jnp code that XLA
// fuses into a pass or two. As eager PyTorch in f32 the same norm takes 6
// passes forward and 13 backward, ~184 bytes of device memory an element a
// training step with the layer's recompute; these move ~14 (the forward reads
// x and writes y, twice with the recompute: 8 in bf16; the backward reads x
// and dy and writes dx: 6).
//
// What bounds them on this card: bytes. An element costs a few FLOP against
// 4-6 bytes, far below the H100's ~295 FLOP/byte ridge, so the aim is to move
// each byte once at the HBM rate: a row is read once with 16-byte vector loads
// into f32 registers, reduced there, and written once with 16-byte stores.
//
// Design:
// - A row is D elements with stride 1; rows are addressed by up to three
//   leading indices with each operand's own strides (kernels/rmsnorm.py
//   merges what it can and refuses the rest), so heads-major q and k seen
//   through the einsum's view (storage [B,T,H,Dh], read as [B,H,T,Dh]) and a
//   dy laid out otherwise go in with no copy. Every row starts 16-byte aligned.
// - The launch shape comes from D (kernels/rmsnorm.launch_shape): a row takes
//   tpr threads, a power of 2, each holding VPT 16-byte vectors, the vectors
//   of a row dealt out round-robin so that neighbouring threads read
//   neighbouring 16 bytes. D <= 256 puts several rows in a warp; D 2048 and
//   4096 spread a row over several warps. The sum of a row is a butterfly of
//   shuffles inside each warp, which leaves every thread of the row the same
//   bits, and for a row of several warps their totals added in shared memory
//   in warp order.
// - The arithmetic is the eager code's, rounding for rounding where it can
//   be: x^2 summed in f32 (the order differs), mean = sum * (1 / D), + eps,
//   rsqrtf (the function PyTorch's rsqrt calls), then (x * rstd) * scale in
//   f32, the scale read in f32, and one rounding to the output's dtype. The
//   backward computes dx in f32 and rounds it once.
// - The backward runs a persistent grid (every CTA resident), so each CTA
//   adds the dy * x^ of many rows into f32 registers, one set a thread for the
//   columns it holds; a CTA adds its row groups in shared memory in order and
//   writes one [D] partial, and rms_bwd_finish_kernel adds the [grid, D]
//   partials in CTA order. No atomics: the scale's gradient is the same from
//   run to run on one card.
//
// Plain C interface (loaded with ctypes): every launcher returns a
// cudaError_t as int (0: launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxD = 8192;
constexpr int kBlock = 256;  // threads of a CTA: 256 / tpr rows
constexpr int kFinishCols = 32;    // columns a finishing CTA takes
constexpr int kFinishSlices = 32;  // and the slices of the partials it splits them into

struct Layout {
  long long s[3];  // a row's leading strides, in elements
};

struct Rows {
  int n;       // rows
  int n1, n2;  // sizes of leading dimensions 1 and 2 (dimension 0 is n / (n1 n2))
  int d;       // elements a row
  int tpr;     // threads a row, a power of 2
  float inv_d, eps;
};

__device__ __forceinline__ long long row_offset(int r, const Rows& rows, const Layout& l) {
  const unsigned i2 = (unsigned)r % (unsigned)rows.n2;
  const unsigned t = (unsigned)r / (unsigned)rows.n2;
  const unsigned i1 = t % (unsigned)rows.n1;
  const unsigned i0 = t / (unsigned)rows.n1;
  return (long long)i0 * l.s[0] + (long long)i1 * l.s[1] + (long long)i2 * l.s[2];
}

// 16 bytes of T as f32 values, and back with one rounding
template <int BF16>
struct Vec {
  using T = std::conditional_t<BF16 != 0, __nv_bfloat16, float>;
  static constexpr int N = 16 / sizeof(T);

  static __device__ __forceinline__ void load(const T* p, float* v) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    if constexpr (BF16) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    } else {
      const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = f[i];
    }
  }

  static __device__ __forceinline__ void store(T* p, const float* v) {
    uint4 raw;
    if constexpr (BF16) {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    } else {
      float* f = reinterpret_cast<float*>(&raw);
#pragma unroll
      for (int i = 0; i < N; ++i) f[i] = v[i];
    }
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// N f32 values of the scale from column c on (16-byte aligned)
template <int N>
__device__ __forceinline__ void load_scale(const float* scale, int c, float* s) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(scale + c + i));
    s[i] = f.x;
    s[i + 1] = f.y;
    s[i + 2] = f.z;
    s[i + 3] = f.w;
  }
}

// The sum of v over the tpr threads of each row, the same bits in each: the
// butterfly adds every pair in both orders, which IEEE addition makes equal.
// A row of several warps adds its warps' sums in `red`, in warp order. Every
// thread of the CTA calls it (tpr is the same for all).
__device__ __forceinline__ float row_sum(float v, int tpr, float* red) {
  const int width = tpr < 32 ? tpr : 32;
  for (int o = width >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (tpr <= 32) return v;
  const int warps = tpr >> 5;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const int first = (threadIdx.x / tpr) * warps;
  v = 0.f;
  for (int w = 0; w < warps; ++w) v += red[first + w];
  __syncthreads();  // red is free again for the next row
  return v;
}

template <int BF16, int VPT>
__global__ void __launch_bounds__(kBlock)
    rms_fwd_kernel(const typename Vec<BF16>::T* __restrict__ x, const Layout lx,
                   typename Vec<BF16>::T* __restrict__ y, const Layout ly,
                   const float* __restrict__ scale, float* __restrict__ rstd, const Rows rows) {
  using V = Vec<BF16>;
  constexpr int N = V::N;
  __shared__ float red[kBlock / 32];
  const int tpr = rows.tpr;
  const int lane = threadIdx.x & (tpr - 1);
  const int r = blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool valid = r < rows.n;
  const int nvec = rows.d / N;
  const typename V::T* xr = x + (valid ? row_offset(r, rows, lx) : 0);
  float v[VPT][N];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j = lane + k * tpr;
    if (valid && j < nvec) {
      V::load(xr + j * N, v[k]);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) v[k][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) ss = fmaf(v[k][i], v[k][i], ss);
  }
  ss = row_sum(ss, tpr, red);
  const float rs = rsqrtf(__fadd_rn(__fmul_rn(ss, rows.inv_d), rows.eps));
  if (!valid) return;
  typename V::T* yr = y + row_offset(r, rows, ly);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j = lane + k * tpr;
    if (j < nvec) {
      float s[N];
      load_scale<N>(scale, j * N, s);
#pragma unroll
      for (int i = 0; i < N; ++i) v[k][i] = __fmul_rn(__fmul_rn(v[k][i], rs), s[i]);
      V::store(yr + j * N, v[k]);
    }
  }
  if (lane == 0) rstd[r] = rs;
}

template <int BF16, int VPT>
__global__ void __launch_bounds__(kBlock)
    rms_bwd_kernel(const typename Vec<BF16>::T* __restrict__ x, const Layout lx,
                   const typename Vec<BF16>::T* __restrict__ dy, const Layout ldy,
                   typename Vec<BF16>::T* __restrict__ dx, const Layout ldx,
                   const float* __restrict__ scale, const float* __restrict__ rstd,
                   float* __restrict__ partials, const Rows rows) {
  using V = Vec<BF16>;
  constexpr int N = V::N;
  __shared__ float red[kBlock / 32];
  extern __shared__ float cols[];  // [row groups of the CTA][d]
  const int tpr = rows.tpr;
  const int groups = blockDim.x / tpr;
  const int group = threadIdx.x / tpr;
  const int lane = threadIdx.x & (tpr - 1);
  const int nvec = rows.d / N;
  float acc[VPT][N];  // sum of dy * x^ over this thread's rows, per column it holds
#pragma unroll
  for (int k = 0; k < VPT; ++k)
#pragma unroll
    for (int i = 0; i < N; ++i) acc[k][i] = 0.f;
  // the loop's bounds are the same for every thread of the CTA (row_sum syncs)
  for (int base = blockIdx.x * groups; base < rows.n; base += gridDim.x * groups) {
    const int r = base + group;
    const bool valid = r < rows.n;
    const float rs = valid ? rstd[r] : 0.f;
    const typename V::T* xr = x + (valid ? row_offset(r, rows, lx) : 0);
    const typename V::T* dyr = dy + (valid ? row_offset(r, rows, ldy) : 0);
    float xh[VPT][N], g[VPT][N];
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int j = lane + k * tpr;
      if (valid && j < nvec) {
        float d_y[N], s[N];
        V::load(xr + j * N, xh[k]);
        V::load(dyr + j * N, d_y);
        load_scale<N>(scale, j * N, s);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          xh[k][i] = __fmul_rn(xh[k][i], rs);
          g[k][i] = __fmul_rn(d_y[i], s[i]);
          dot = fmaf(g[k][i], xh[k][i], dot);
          acc[k][i] = fmaf(d_y[i], xh[k][i], acc[k][i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) xh[k][i] = g[k][i] = 0.f;
      }
    }
    dot = row_sum(dot, tpr, red);
    const float m = __fmul_rn(dot, rows.inv_d);
    if (!valid) continue;
    typename V::T* dxr = dx + row_offset(r, rows, ldx);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int j = lane + k * tpr;
      if (j < nvec) {
#pragma unroll
        for (int i = 0; i < N; ++i) g[k][i] = __fmul_rn(rs, fmaf(-xh[k][i], m, g[k][i]));
        V::store(dxr + j * N, g[k]);
      }
    }
  }
  // this CTA's partial of the scale's gradient: its row groups added in order
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j = lane + k * tpr;
    if (j < nvec) {
#pragma unroll
      for (int i = 0; i < N; ++i) cols[group * rows.d + j * N + i] = acc[k][i];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < rows.d; c += blockDim.x) {
    float t = 0.f;
    for (int q = 0; q < groups; ++q) t += cols[q * rows.d + c];
    partials[(long long)blockIdx.x * rows.d + c] = t;
  }
}

// dscale[c] = the sum over b of partials[b][c], in b order within each of the
// CTA's 32 slices, then the slices in order
__global__ void __launch_bounds__(kFinishCols * kFinishSlices)
    rms_bwd_finish_kernel(const float* __restrict__ partials, int blocks, int d,
                          float* __restrict__ dscale) {
  __shared__ float part[kFinishSlices][kFinishCols + 1];
  const int c = blockIdx.x * kFinishCols + threadIdx.x;
  float t = 0.f;
  if (c < d) {
    for (int b = threadIdx.y; b < blocks; b += kFinishSlices) t += partials[(long long)b * d + c];
  }
  part[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    float u = 0.f;
    for (int q = 0; q < kFinishSlices; ++q) u += part[q][threadIdx.x];
    dscale[c] = u;
  }
}

// What every launch checks: a launch shape whose rows cover d elements in
// 16-byte vectors of n elements.
bool shape_ok(const Rows& rows, int vpt, int n) {
  const int tpr = rows.tpr;
  return rows.n > 0 && rows.n1 > 0 && rows.n2 > 0 && rows.d > 0 && rows.d <= kMaxD &&
         rows.d % n == 0 && tpr > 0 && tpr <= kBlock && (tpr & (tpr - 1)) == 0 &&
         tpr * vpt * n >= rows.d;
}

Rows make_rows(int n, int n1, int n2, int d, int tpr, float inv_d, float eps) {
  Rows r;
  r.n = n; r.n1 = n1; r.n2 = n2; r.d = d; r.tpr = tpr; r.inv_d = inv_d; r.eps = eps;
  return r;
}

Layout make_layout(const long long* s) {
  Layout l;
  l.s[0] = s[0]; l.s[1] = s[1]; l.s[2] = s[2];
  return l;
}

size_t bwd_smem(int tpr, int d) { return sizeof(float) * (size_t)(kBlock / tpr) * d; }

template <int BF16, int VPT>
int fwd(const void* x, const long long* sx, void* y, const long long* sy, const float* scale,
        float* rstd, const Rows& rows, cudaStream_t stream) {
  using T = typename Vec<BF16>::T;
  const int per_cta = kBlock / rows.tpr;
  const int grid = (rows.n + per_cta - 1) / per_cta;
  rms_fwd_kernel<BF16, VPT><<<grid, kBlock, 0, stream>>>(
      reinterpret_cast<const T*>(x), make_layout(sx), reinterpret_cast<T*>(y), make_layout(sy),
      scale, rstd, rows);
  return (int)cudaGetLastError();
}

template <int BF16, int VPT>
int bwd(const void* x, const long long* sx, const void* dy, const long long* sdy, void* dx,
        const long long* sdx, const float* scale, const float* rstd, float* partials,
        const Rows& rows, int grid, cudaStream_t stream) {
  using T = typename Vec<BF16>::T;
  rms_bwd_kernel<BF16, VPT><<<grid, kBlock, bwd_smem(rows.tpr, rows.d), stream>>>(
      reinterpret_cast<const T*>(x), make_layout(sx), reinterpret_cast<const T*>(dy),
      make_layout(sdy), reinterpret_cast<T*>(dx), make_layout(sdx), scale, rstd, partials, rows);
  return (int)cudaGetLastError();
}

template <int BF16, int VPT>
int bwd_per_sm(size_t smem, int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, rms_bwd_kernel<BF16, VPT>,
                                                            kBlock, smem);
}

template <int N>
using Int = std::integral_constant<int, N>;

// f(Int<BF16>, Int<VPT>) for the template instance that (bf16, vpt) names;
// cudaErrorInvalidValue for a vpt that has none
template <class F>
int dispatch(int bf16, int vpt, F f) {
  switch (bf16 ? vpt : -vpt) {
    case 1: return f(Int<1>(), Int<1>());
    case 2: return f(Int<1>(), Int<2>());
    case 4: return f(Int<1>(), Int<4>());
    case 8: return f(Int<1>(), Int<8>());
    case -1: return f(Int<0>(), Int<1>());
    case -2: return f(Int<0>(), Int<2>());
    case -4: return f(Int<0>(), Int<4>());
    case -8: return f(Int<0>(), Int<8>());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// what kernels/rmsnorm.py plans with: the widest row, the threads of a CTA
int tpujob_rms_limits(int which) { return which == 0 ? kMaxD : kBlock; }

// The forward over n rows of d elements: x and y bf16 (else f32), each with
// its three leading strides s*; scale d f32 values; rstd n f32 values.
int tpujob_rms_fwd(const void* x, const long long* sx, void* y, const long long* sy,
                   const float* scale, float* rstd, int bf16, int n, int n1, int n2, int d,
                   int vpt, int tpr, float inv_d, float eps, void* stream) {
  const Rows rows = make_rows(n, n1, n2, d, tpr, inv_d, eps);
  if (!shape_ok(rows, vpt, bf16 ? 8 : 4)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch(bf16, vpt, [&](auto b, auto v) {
    return fwd<decltype(b)::value, decltype(v)::value>(x, sx, y, sy, scale, rstd, rows, s);
  });
}

// The backward's persistent grid for n rows: the CTAs the card holds at once
// at this launch shape (its SMs times the CTAs an SM holds), or fewer if the
// rows need fewer
int tpujob_rms_bwd_grid(int bf16, int vpt, int tpr, int d, int n, int* grid) {
  if (tpr <= 0 || tpr > kBlock || d <= 0 || d > kMaxD || n <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = bwd_smem(tpr, d);
  const int rc = dispatch(bf16, vpt, [&](auto b, auto v) {
    return bwd_per_sm<decltype(b)::value, decltype(v)::value>(smem, &per_sm);
  });
  if (rc) return rc;
  const int per_cta = kBlock / tpr;
  const int needed = (n + per_cta - 1) / per_cta;
  const int most = sms * (per_sm > 0 ? per_sm : 1);
  *grid = needed < most ? needed : most;
  return 0;
}

// The backward over n rows: dx from x and dy (each with its strides), scale
// and the forward's rstd; partials [grid, d] f32, a row a CTA
int tpujob_rms_bwd(const void* x, const long long* sx, const void* dy, const long long* sdy,
                   void* dx, const long long* sdx, const float* scale, const float* rstd,
                   float* partials, int bf16, int n, int n1, int n2, int d, int vpt, int tpr,
                   int grid, float inv_d, void* stream) {
  const Rows rows = make_rows(n, n1, n2, d, tpr, inv_d, 0.f);
  if (!shape_ok(rows, vpt, bf16 ? 8 : 4) || grid < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch(bf16, vpt, [&](auto b, auto v) {
    return bwd<decltype(b)::value, decltype(v)::value>(x, sx, dy, sdy, dx, sdx, scale, rstd,
                                                       partials, rows, grid, s);
  });
}

// dscale (d f32) = the sum of the partials [blocks, d] over blocks, in a
// fixed order
int tpujob_rms_bwd_finish(const float* partials, int blocks, int d, float* dscale, void* stream) {
  if (blocks < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const dim3 threads(kFinishCols, kFinishSlices);
  const int grid = (d + kFinishCols - 1) / kFinishCols;
  rms_bwd_finish_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(partials, blocks, d, dscale);
  return (int)cudaGetLastError();
}

const char* tpujob_rms_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
