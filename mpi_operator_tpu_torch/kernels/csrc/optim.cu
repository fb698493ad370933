// The trainer's optimizer phase on Hopper (sm_90a) as two multi-tensor
// kernels over f32 parameters (ops/trainer.py, through kernels/optim.py):
//
//   K-norm  sumsq_kernel (+ sumsq_finish_kernel): the sum of squares of
//           many gradients, the clip's global norm before its square root;
//   K-adamw adamw_kernel<MU_BF16>: the clip's scale and the AdamW update,
//           reading p, g, mu and nu once and writing p, mu and nu once.
//
// They replace no Pallas kernel: the JAX trainer runs optax's
// clip_by_global_norm and adamw, which XLA fuses into a few passes. As
// eager PyTorch, one pass per operation and leaf, the same work moves ~126
// bytes of device memory a parameter; these move 28 (K-norm reads g: 4;
// K-adamw reads p, g, a bf16 mu and nu: 14, and writes p, mu, nu: 10).
//
// What bounds them on this card: bytes. An element costs a few FLOP against
// 24-28 bytes, far below the H100's ~295 FLOP/byte ridge, so the one aim is
// to stream at the HBM rate: 16-byte vector loads and stores, several in
// flight a thread, every CTA resident at once.
//
// Design:
// - One launch walks a table of leaves, passed by value in the kernel's
//   parameter space (up to 32,764 bytes with CUDA 12.1+; 4 KB before), so
//   building it costs the host no copy and the device no read of host
//   memory. A leaf is cut into chunks of kChunk elements; chunk_end holds
//   each leaf's cumulative chunk count, so a CTA finds the leaf of a chunk
//   by binary search, and the CTAs stride over the launch's chunks. More
//   leaves than a table holds take more launches (kernels/optim.py plans
//   them).
// - A chunk's f32 vectors start 16 bytes apart from the leaf's first, so a
//   leaf whose pointers are all 16-byte aligned (8 for a bf16 mu) takes the
//   vector path, and the rest of its last chunk past the last whole vector
//   an element at a time; a leaf that is not aligned goes element by element
//   through the same kernel.
// - K-norm writes one f32 partial per chunk (an order fixed by the table,
//   not by the grid); one CTA then sums the partials in double. No atomics:
//   the sum is the same from run to run.
// - K-adamw reads the norm from device memory (no host sync), and computes
//   the clip's factor as the plain path does: 1 below max_norm, else
//   max_norm * (1 / norm). Its arithmetic is the plain path's on the card,
//   rounding for rounding: g' = g * factor; m = f32(bf16(mu * bf16(b1))) +
//   (1 - b1) g' (f32 mu: mu * b1 in f32); nu = b2 nu + (1 - b2) g'^2; upd
//   = (m / bc1) / (sqrt(nu / bc2) + eps) (+ wd p); p -= lr upd; mu stored
//   in its own dtype. A division by bc1 or bc2 is a product with its f32
//   reciprocal, as PyTorch divides a CUDA tensor by a Python number; the
//   one division of two values and the square root are IEEE (nvcc's
//   defaults, no fast math), and each a + b c is one fused multiply-add,
//   as nvcc compiles PyTorch's own kernels.
//
// Plain C interface (loaded with ctypes): every launcher returns a
// cudaError_t as int (0: launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;          // f32 elements in a 16-byte vector
constexpr int kChunk = 32768;    // elements a CTA takes at a time (kVec divides it)
constexpr int kFinishThreads = 1024;

#if defined(CUDART_VERSION) && CUDART_VERSION >= 12010
constexpr int kParamBytes = 32764;
#else
constexpr int kParamBytes = 4096;
#endif
constexpr int kOtherParamBytes = 128;  // room for each kernel's other parameters

struct NormLeaf {
  const float* g;
  long long n;
};

struct AdamwLeaf {
  float* p;
  const float* g;
  void* mu;
  float* nu;
  long long n;
};

constexpr int kNormLeaves = (kParamBytes - kOtherParamBytes) / (sizeof(NormLeaf) + sizeof(int));
constexpr int kAdamwLeaves = (kParamBytes - kOtherParamBytes) / (sizeof(AdamwLeaf) + sizeof(int));

template <class Leaf, int N>
struct Table {
  Leaf leaf[N];
  int chunk_end[N];  // chunks of leaves 0..i
  int n_leaves;
};

using NormTable = Table<NormLeaf, kNormLeaves>;
using AdamwTable = Table<AdamwLeaf, kAdamwLeaves>;

// The scalars of an update (kernels/optim.py passes them in this order).
struct Hyper {
  float neg_lr, b1, one_minus_b1, b2, one_minus_b2, inv_bc1, inv_bc2, eps, wd, max_norm;
};

static_assert(sizeof(NormTable) + sizeof(float*) <= kParamBytes, "K-norm's table");
static_assert(sizeof(AdamwTable) + sizeof(float*) + sizeof(Hyper) <= kParamBytes,
              "K-adamw's table");

template <class T>
__device__ __forceinline__ int leaf_of(const T& t, int chunk) {
  int lo = 0, hi = t.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t.chunk_end[mid] > chunk) hi = mid; else lo = mid + 1;
  }
  return lo;
}

template <class T>
__device__ __forceinline__ T block_sum(T v, T* shared) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    if (lane < (int)(blockDim.x >> 5)) v = shared[lane];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  __syncthreads();  // shared is free again for the next call
  return v;
}

__device__ __forceinline__ bool aligned(const void* ptr, int bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) & (uintptr_t)(bytes - 1)) == 0;
}

// K-norm: partials[c] = sum of the squares of chunk c's elements
__global__ void __launch_bounds__(kThreads) sumsq_kernel(const NormTable t, float* partials) {
  __shared__ float shared[kThreads / 32];
  const int total = t.chunk_end[t.n_leaves - 1];
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    const int i = leaf_of(t, c);
    const NormLeaf leaf = t.leaf[i];
    const long long start = (long long)(c - (i ? t.chunk_end[i - 1] : 0)) * kChunk;
    const long long count = min((long long)kChunk, leaf.n - start);
    const float* g = leaf.g + start;
    float acc = 0.f;
    long long done = 0;
    if (aligned(leaf.g, 16)) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      const int nv = (int)(count / kVec);
      int v = threadIdx.x;
      for (; v + 3 * kThreads < nv; v += 4 * kThreads) {
        float4 x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) x[u] = __ldcs(g4 + v + u * kThreads);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc = fmaf(x[u].x, x[u].x, acc);
          acc = fmaf(x[u].y, x[u].y, acc);
          acc = fmaf(x[u].z, x[u].z, acc);
          acc = fmaf(x[u].w, x[u].w, acc);
        }
      }
      for (; v < nv; v += kThreads) {
        const float4 x = __ldcs(g4 + v);
        acc = fmaf(x.x, x.x, acc);
        acc = fmaf(x.y, x.y, acc);
        acc = fmaf(x.z, x.z, acc);
        acc = fmaf(x.w, x.w, acc);
      }
      done = (long long)nv * kVec;
    }
    for (long long j = done + threadIdx.x; j < count; j += kThreads) {
      const float x = __ldcs(g + j);
      acc = fmaf(x, x, acc);
    }
    acc = block_sum(acc, shared);
    if (threadIdx.x == 0) partials[c] = acc;
  }
}

// *out = the sum of n partials, added in double, rounded once to f32
__global__ void __launch_bounds__(kFinishThreads)
    sumsq_finish_kernel(const float* partials, int n, float* out) {
  __shared__ double shared[kFinishThreads / 32];
  double acc = 0.0;
  for (int j = threadIdx.x; j < n; j += blockDim.x) acc += (double)partials[j];
  acc = block_sum(acc, shared);
  if (threadIdx.x == 0) *out = (float)acc;
}

template <int MU_BF16>
__device__ __forceinline__ float load_mu(const void* mu, long long j) {
  if constexpr (MU_BF16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(mu)[j]);
  } else {
    return reinterpret_cast<const float*>(mu)[j];
  }
}

template <int MU_BF16>
__device__ __forceinline__ void store_mu(void* mu, long long j, float m) {
  if constexpr (MU_BF16) {
    reinterpret_cast<__nv_bfloat16*>(mu)[j] = __float2bfloat16_rn(m);
  } else {
    reinterpret_cast<float*>(mu)[j] = m;
  }
}

// One element: p, mu (as f32) and nu in, their new values out.
template <int MU_BF16>
__device__ __forceinline__ void update(float& p, float g, float& mu, float& nu, float factor,
                                       const Hyper& h) {
  g = __fmul_rn(g, factor);
  float mb = __fmul_rn(mu, h.b1);
  if constexpr (MU_BF16) mb = __bfloat162float(__float2bfloat16_rn(mb));
  const float m = fmaf(h.one_minus_b1, g, mb);
  nu = fmaf(h.one_minus_b2, __fmul_rn(g, g), __fmul_rn(nu, h.b2));
  float upd = __fmul_rn(m, h.inv_bc1) / (sqrtf(__fmul_rn(nu, h.inv_bc2)) + h.eps);
  if (h.wd != 0.f) upd = fmaf(h.wd, p, upd);
  p = fmaf(h.neg_lr, upd, p);
  mu = m;
}

// K-adamw: the clip's scale (norm null: none) and the update of every leaf
template <int MU_BF16>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const AdamwTable t, const float* norm, const Hyper h) {
  float factor = 1.f;
  if (norm != nullptr) {
    const float n = *norm;
    factor = n < h.max_norm ? 1.f : __fmul_rn(1.f / n, h.max_norm);
  }
  const int total = t.chunk_end[t.n_leaves - 1];
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    const int i = leaf_of(t, c);
    const AdamwLeaf leaf = t.leaf[i];
    const long long start = (long long)(c - (i ? t.chunk_end[i - 1] : 0)) * kChunk;
    const long long count = min((long long)kChunk, leaf.n - start);
    float* p = leaf.p + start;
    const float* g = leaf.g + start;
    float* nu = leaf.nu + start;
    void* mu = MU_BF16 ? (void*)(reinterpret_cast<__nv_bfloat16*>(leaf.mu) + start)
                       : (void*)(reinterpret_cast<float*>(leaf.mu) + start);
    long long done = 0;
    if (aligned(leaf.p, 16) && aligned(leaf.g, 16) && aligned(leaf.nu, 16) &&
        aligned(leaf.mu, MU_BF16 ? 8 : 16)) {
      float4* p4 = reinterpret_cast<float4*>(p);
      const float4* g4 = reinterpret_cast<const float4*>(g);
      float4* nu4 = reinterpret_cast<float4*>(nu);
      const int nv = (int)(count / kVec);
      for (int v = threadIdx.x; v < nv; v += kThreads) {
        float4 pv = p4[v];
        const float4 gv = __ldcs(g4 + v);
        float4 nv4 = nu4[v];
        float4 mv;
        if constexpr (MU_BF16) {
          const uint2 raw = reinterpret_cast<const uint2*>(mu)[v];
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
          mv = make_float4(lo.x, lo.y, hi.x, hi.y);
        } else {
          mv = reinterpret_cast<const float4*>(mu)[v];
        }
        update<MU_BF16>(pv.x, gv.x, mv.x, nv4.x, factor, h);
        update<MU_BF16>(pv.y, gv.y, mv.y, nv4.y, factor, h);
        update<MU_BF16>(pv.z, gv.z, mv.z, nv4.z, factor, h);
        update<MU_BF16>(pv.w, gv.w, mv.w, nv4.w, factor, h);
        p4[v] = pv;
        nu4[v] = nv4;
        if constexpr (MU_BF16) {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(mv.x, mv.y);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(mv.z, mv.w);
          uint2 raw;
          raw.x = *reinterpret_cast<const unsigned int*>(&lo);
          raw.y = *reinterpret_cast<const unsigned int*>(&hi);
          reinterpret_cast<uint2*>(mu)[v] = raw;
        } else {
          reinterpret_cast<float4*>(mu)[v] = mv;
        }
      }
      done = (long long)nv * kVec;
    }
    for (long long j = done + threadIdx.x; j < count; j += kThreads) {
      float pj = p[j], mj = load_mu<MU_BF16>(mu, j), nj = nu[j];
      update<MU_BF16>(pj, g[j], mj, nj, factor, h);
      p[j] = pj;
      nu[j] = nj;
      store_mu<MU_BF16>(mu, j, mj);
    }
  }
}

// CTAs for `chunks` chunks: every chunk its own CTA up to what the card
// holds at once; past that the resident CTAs stride over the rest. The
// card's capacity for each kernel (`slot`) is asked once a process.
template <class K>
int grid_for(K kernel, int slot, int chunks, cudaError_t* err) {
  static int most[3] = {0, 0, 0};
  *err = cudaSuccess;
  if (most[slot] == 0) {
    int device = 0, sms = 0, per_sm = 0;
    *err = cudaGetDevice(&device);
    if (*err == cudaSuccess)
      *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (*err == cudaSuccess)
      *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (*err != cudaSuccess) return 0;
    most[slot] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return chunks < most[slot] ? chunks : most[slot];
}

template <class T, class Leaf>
int fill(T* t, const long long* leaves, const int* chunk_end, int n, int capacity) {
  if (n < 1 || n > capacity) return (int)cudaErrorInvalidValue;
  static_assert(sizeof(Leaf) % sizeof(long long) == 0, "a leaf is whole 8-byte words");
  constexpr int words = sizeof(Leaf) / sizeof(long long);
  for (int i = 0; i < n; ++i) {
    Leaf leaf;
    long long* dst = reinterpret_cast<long long*>(&leaf);
    for (int w = 0; w < words; ++w) dst[w] = leaves[i * words + w];
    t->leaf[i] = leaf;
    t->chunk_end[i] = chunk_end[i];
    if (chunk_end[i] < (i ? chunk_end[i - 1] : 0)) return (int)cudaErrorInvalidValue;
  }
  t->n_leaves = n;
  return chunk_end[n - 1] > 0 ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int tpujob_optim_chunk() { return kChunk; }

// leaves a launch takes: 0 K-norm, 1 K-adamw
int tpujob_optim_capacity(int kernel) { return kernel == 0 ? kNormLeaves : kAdamwLeaves; }

// K-norm over n leaves: leaves holds (pointer, numel) per leaf as 64-bit
// words, chunk_end the cumulative chunks; partials one f32 per chunk
int tpujob_sumsq_launch(const long long* leaves, const int* chunk_end, int n, float* partials,
                        void* stream) {
  NormTable t;
  int rc = fill<NormTable, NormLeaf>(&t, leaves, chunk_end, n, kNormLeaves);
  if (rc) return rc;
  cudaError_t err;
  const int grid = grid_for(sumsq_kernel, 0, t.chunk_end[n - 1], &err);
  if (err != cudaSuccess) return (int)err;
  sumsq_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(t, partials);
  return (int)cudaGetLastError();
}

int tpujob_sumsq_finish(const float* partials, int n, float* out, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  sumsq_finish_kernel<<<1, kFinishThreads, 0, (cudaStream_t)stream>>>(partials, n, out);
  return (int)cudaGetLastError();
}

// K-adamw over n leaves: leaves holds (p, g, mu, nu, numel) per leaf as
// 64-bit words; norm null: no clip; hyper the 10 floats of Hyper
int tpujob_adamw_launch(const long long* leaves, const int* chunk_end, int n, int mu_bf16,
                        const float* norm, const float* hyper, void* stream) {
  AdamwTable t;
  int rc = fill<AdamwTable, AdamwLeaf>(&t, leaves, chunk_end, n, kAdamwLeaves);
  if (rc) return rc;
  Hyper h;
  h.neg_lr = hyper[0]; h.b1 = hyper[1]; h.one_minus_b1 = hyper[2]; h.b2 = hyper[3];
  h.one_minus_b2 = hyper[4]; h.inv_bc1 = hyper[5]; h.inv_bc2 = hyper[6]; h.eps = hyper[7];
  h.wd = hyper[8]; h.max_norm = hyper[9];
  cudaError_t err;
  const int chunks = t.chunk_end[n - 1];
  cudaStream_t s = (cudaStream_t)stream;
  if (mu_bf16) {
    const int grid = grid_for(adamw_kernel<1>, 1, chunks, &err);
    if (err != cudaSuccess) return (int)err;
    adamw_kernel<1><<<grid, kThreads, 0, s>>>(t, norm, h);
  } else {
    const int grid = grid_for(adamw_kernel<0>, 2, chunks, &err);
    if (err != cudaSuccess) return (int)err;
    adamw_kernel<0><<<grid, kThreads, 0, s>>>(t, norm, h);
  }
  return (int)cudaGetLastError();
}

const char* tpujob_optim_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
