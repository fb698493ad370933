// Flash attention for Hopper (sm_90a): forward (K1) and the two backward
// kernels (K2: dq, K3: dk/dv), bf16 operands, f32 accumulation.
//
// Replaces the three Pallas TPU kernels of
// mpi_operator_tpu/kernels/flash_attention.py:
//   K1 flash_fwd_kernel     <- _fwd_kernel      (pallas_call in _flash_fwd)
//   K2 flash_bwd_dq_kernel  <- _bwd_dq_kernel   (first pallas_call in _flash_bwd)
//   K3 flash_bwd_dkv_kernel <- _bwd_dkv_kernel  (second pallas_call in _flash_bwd)
//
// What bounds them on this card: operations. At the Llama shape (T=2048,
// D=128) each kernel does ~D/2 tensor-core FLOP per byte it must move, well
// above the H100's ~295 FLOP/byte ridge, so the tensor cores are the limit.
// This first design is the plain, correct one: 64x64 (Q x K) tiles, four
// warps per block, each warp owning 16 rows of the tile, nvcuda::wmma
// 16x16x16 bf16 -> f32 products on tiles staged in padded shared memory.
// wgmma, TMA and warp specialisation are later speed steps.
//
// Design notes against the TPU kernels:
// - The TPU grid runs in order and carries (acc, m, l) in VMEM scratch across
//   the innermost grid axis. Here that axis is a loop inside the block, and
//   the block grid covers (q-tile, b*h) for K1/K2 and (k-tile, b*h_kv) for K3.
// - Causal tile skipping is a loop bound from the same algebra as
//   _causal_last_k_tile / _causal_first_q_tile, not a clamp of an index map.
// - The TPU wrappers zero-pad T to block multiples; here every tile load
//   zero-fills the rows past T and the score mask (k_idx < T) keeps them out,
//   so no padded copy of q/k/v is made. Rows past T are never stored.
// - K3 loops over the g q-heads of a kv head inside the block and sums their
//   dk/dv in f32 registers: no per-q-head [B,H,T,D] partials, no atomics.
// - Rounding points match the TPU kernels: P is rounded to bf16 before P.V,
//   dS to bf16 before its products, dq/dk scaled by `scale` when emitted.
//
// Plain C interface (loaded with ctypes): every launcher returns
// cudaGetLastError() right after its launch, and the Python wrapper raises on
// anything but 0. Layouts are contiguous: q/o/dO/dq [B,H,T,D], k/v/dk/dv
// [B,Hkv,T,D], lse/delta [B,H,T] f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;           // q rows per tile
constexpr int BK = 64;           // k rows per tile
constexpr int NWARPS = 4;        // each warp owns 16 rows of a 64-row tile
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;  // large-negative, not -inf: exp() stays NaN-free

// Padded shared-memory row strides (elements). The pads break the 2-way..8-way
// bank conflicts of 128/256-byte rows and keep every 16-row tile start
// 32-byte aligned, as wmma::load_matrix_sync requires.
template <int D> struct Ld {
  static constexpr int kBf16Tile = D + 8;   // bf16 [rows, D] tiles
  static constexpr int kF32Tile = D + 4;    // f32 [rows, D] staging
};
constexpr int LDP = BK + 8;                  // bf16 [64, 64] tiles (P, dS)
constexpr int LDS = BK + 4;                  // f32 [64, 64] tiles (S, dP)

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// _causal_last_k_tile: largest ki whose tile meets q tile qi's causal region.
__device__ __forceinline__ int causal_last_k_tile(int qi) {
  return ((qi + 1) * BQ + BK - 1) / BK - 1;
}

// _causal_first_q_tile: smallest qi whose tile meets k tile ki's causal region.
__device__ __forceinline__ int causal_first_q_tile(int ki) {
  return (ki * BK) / BQ;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy rows [row0, row0+ROWS) of a contiguous [T, D] bf16 matrix into a padded
// shared tile, 16 bytes per thread per step; rows at or past T are zero-filled
// (their contents would otherwise be whatever lies beyond the tensor).
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          int row0, int T) {
  constexpr int VEC = 8;
  constexpr int PER_ROW = D / VEC;
  constexpr int LD = Ld<D>::kBf16Tile;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += NTHREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// rows [row0, row0+64) of a [T] f32 vector, 0 past T
__device__ __forceinline__ void load_rows_f32(float* dst, const float* __restrict__ src,
                                              int row0, int T) {
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) dst[i] = (row0 + i < T) ? src[row0 + i] : 0.f;
}

// out[16 x 64] (f32, ldm LDS) = A[16 rows at a, D wide] . B[64 rows at b, D wide]^T
template <int D>
__device__ __forceinline__ void warp_abt(float* out, const bf16* a, const bf16* b) {
  constexpr int LD = Ld<D>::kBf16Tile;
  FragC acc[BK / 16];
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, LD);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      FragBCol fb;  // B^T read column-major straight from the row-major tile
      wmma::load_matrix_sync(fb, b + j * 16 * LD + kk, LD);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
    wmma::store_matrix_sync(out + j * 16, acc[j], LDS, wmma::mem_row_major);
}

// acc[j] (16 x 16 column block j of a 16 x D result) += A[16 x 64 at a, ldm LDP] . B[64 x D]
template <int D>
__device__ __forceinline__ void warp_ab_accum(FragC* acc, const bf16* a, const bf16* b) {
  constexpr int LD = Ld<D>::kBf16Tile;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, LDP);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, b + kk * LD + j * 16, LD);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

template <int D> struct FwdSmem {
  static constexpr size_t kBytes =
      3 * (size_t)BQ * Ld<D>::kBf16Tile * sizeof(bf16)   // Q, K, V
      + (size_t)BQ * LDP * sizeof(bf16)                  // P
      + (size_t)BQ * LDS * sizeof(float)                 // S
      + (size_t)BQ * Ld<D>::kF32Tile * sizeof(float)     // O accumulator
      + 2 * (size_t)BQ * sizeof(float);                  // m, l
};

// K1. Block (q-tile, b*h); loops over k tiles with the online softmax.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int T, int causal, float scale) {
  constexpr int LD = Ld<D>::kBf16Tile;
  constexpr int LDO = Ld<D>::kF32Tile;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LD;
  bf16* sV = sK + BK * LD;
  bf16* sP = sV + BK * LD;
  float* sS = reinterpret_cast<float*>(sP + BQ * LDP);
  float* sO = sS + BQ * LDS;
  float* sM = sO + BQ * LDO;
  float* sL = sM + BQ;

  // heaviest causal tiles (last q tiles) are scheduled first
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const bf16* qp = q + (size_t)bh * T * D;
  const bf16* kp = k + (size_t)(b * Hkv + hk) * T * D;
  const bf16* vp = v + (size_t)(b * Hkv + hk) * T * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int q0 = qi * BQ;

  load_tile<D, BQ>(sQ, qp, q0, T);
  for (int i = threadIdx.x; i < BQ * LDO; i += NTHREADS) sO[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    sM[i] = NEG_INF;
    sL[i] = 0.f;
  }
  const int n_kb = (T + BK - 1) / BK;
  const int k_end = causal ? min(n_kb, causal_last_k_tile(qi) + 1) : n_kb;

  for (int ki = 0; ki < k_end; ++ki) {
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile<D, BK>(sK, kp, ki * BK, T);
    load_tile<D, BK>(sV, vp, ki * BK, T);
    __syncthreads();

    warp_abt<D>(sS + r0 * LDS, sQ + r0 * LD, sK);
    __syncwarp();

    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const int q_idx = q0 + r;
      float s[2];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        const int k_idx = ki * BK + col;
        const bool valid = k_idx < T && (!causal || q_idx >= k_idx);
        s[c] = valid ? sS[r * LDS + col] * scale : NEG_INF;
        mx = fmaxf(mx, s[c]);
      }
      mx = warp_max(mx);
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s[0] - m_new);
      const float p1 = expf(s[1] - m_new);
      const float psum = warp_sum(p0 + p1);  // the f32 p, before its bf16 rounding
      const float corr = expf(m_prev - m_new);
      sP[r * LDP + lane] = __float2bfloat16(p0);
      sP[r * LDP + lane + 32] = __float2bfloat16(p1);
      for (int c = lane; c < D; c += 32) sO[r * LDO + c] *= corr;
      __syncwarp();
      if (lane == 0) {
        sL[r] = sL[r] * corr + psum;
        sM[r] = m_new;
      }
    }
    __syncwarp();

    // O[r0:r0+16, :] += P[r0:r0+16, :] . V
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      FragC acc;
      wmma::load_matrix_sync(acc, sO + r0 * LDO + j * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, sP + r0 * LDP + kk, LDP);
        FragBRow fb;
        wmma::load_matrix_sync(fb, sV + kk * LD + j * 16, LD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sO + r0 * LDO + j * 16, acc, LDO, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // emit the warp's rows; fully masked rows (l == 0) give o = 0, not NaN
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    const int q_idx = q0 + r;
    if (q_idx >= T) break;
    const float l = sL[r];
    const float safe = (l == 0.f) ? 1.f : l;
    bf16* orow = o + ((size_t)bh * T + q_idx) * D;
    for (int c = lane; c < D; c += 32) orow[c] = __float2bfloat16(sO[r * LDO + c] / safe);
    if (lane == 0) lse[(size_t)bh * T + q_idx] = sM[r] + logf(safe);
  }
}

template <int D> struct DqSmem {
  static constexpr size_t kBytes =
      4 * (size_t)BQ * Ld<D>::kBf16Tile * sizeof(bf16)   // Q, dO, K, V
      + (size_t)BQ * LDP * sizeof(bf16)                  // dS
      + 2 * (size_t)BQ * LDS * sizeof(float)             // S, dP (then dq staging)
      + 2 * (size_t)BQ * sizeof(float);                  // lse, delta
};

// K2. Block (q-tile, b*h): dq = scale * sum_k dS.K with P recomputed from lse.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int H, int Hkv, int T, int causal, float scale) {
  constexpr int LD = Ld<D>::kBf16Tile;
  constexpr int LDO = Ld<D>::kF32Tile;
  static_assert(BQ * LDO <= 2 * BQ * LDS, "dq staging must fit in the S/dP area");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BQ * LD;
  bf16* sK = sdO + BQ * LD;
  bf16* sV = sK + BK * LD;
  bf16* sdS = sV + BK * LD;
  float* sS = reinterpret_cast<float*>(sdS + BQ * LDP);
  float* sdP = sS + BQ * LDS;
  float* sLse = sdP + BQ * LDS;
  float* sDelta = sLse + BQ;

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const bf16* kp = k + (size_t)(b * Hkv + hk) * T * D;
  const bf16* vp = v + (size_t)(b * Hkv + hk) * T * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int q0 = qi * BQ;

  load_tile<D, BQ>(sQ, q + (size_t)bh * T * D, q0, T);
  load_tile<D, BQ>(sdO, dout + (size_t)bh * T * D, q0, T);
  load_rows_f32(sLse, lse + (size_t)bh * T, q0, T);
  load_rows_f32(sDelta, delta + (size_t)bh * T, q0, T);

  FragC acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  const int n_kb = (T + BK - 1) / BK;
  const int k_end = causal ? min(n_kb, causal_last_k_tile(qi) + 1) : n_kb;
  for (int ki = 0; ki < k_end; ++ki) {
    __syncthreads();
    load_tile<D, BK>(sK, kp, ki * BK, T);
    load_tile<D, BK>(sV, vp, ki * BK, T);
    __syncthreads();

    warp_abt<D>(sS + r0 * LDS, sQ + r0 * LD, sK);     // S  = Q K^T
    warp_abt<D>(sdP + r0 * LDS, sdO + r0 * LD, sV);   // dP = dO V^T
    __syncwarp();
    for (int i = lane; i < 16 * BK; i += 32) {
      const int r = r0 + i / BK, c = i % BK;
      const int q_idx = q0 + r, k_idx = ki * BK + c;
      const bool valid = k_idx < T && (!causal || q_idx >= k_idx);
      const float p = valid ? expf(sS[r * LDS + c] * scale - sLse[r]) : 0.f;
      sdS[r * LDP + c] = __float2bfloat16(p * (sdP[r * LDS + c] - sDelta[r]));
    }
    __syncwarp();
    warp_ab_accum<D>(acc, sdS + r0 * LDP, sK);        // dq += dS K
  }
  __syncthreads();  // the staging area aliases other warps' S/dP rows

  float* sOut = sS;
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(sOut + r0 * LDO + j * 16, acc[j], LDO, wmma::mem_row_major);
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int q_idx = q0 + r0 + rr;
    if (q_idx >= T) break;
    bf16* row = dq + ((size_t)bh * T + q_idx) * D;
    for (int c = lane; c < D; c += 32)
      row[c] = __float2bfloat16(sOut[(r0 + rr) * LDO + c] * scale);
  }
}

template <int D> struct DkvSmem {
  static constexpr size_t kBytes =
      4 * (size_t)BQ * Ld<D>::kBf16Tile * sizeof(bf16)   // K, V, Q, dO
      + 2 * (size_t)BQ * LDP * sizeof(bf16)              // P^T, dS^T
      + 2 * (size_t)BQ * LDS * sizeof(float)             // S^T, dP^T (then staging)
      + 2 * (size_t)BQ * sizeof(float);                  // lse, delta
};

// K3. Block (k-tile, b*h_kv): dv = sum_q P^T.dO and dk = scale * sum_q dS^T.Q,
// summed over the g q-heads of the kv head in f32 registers.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                     int H, int Hkv, int T, int causal, float scale) {
  constexpr int LD = Ld<D>::kBf16Tile;
  constexpr int LDO = Ld<D>::kF32Tile;
  static_assert(BK * LDO <= 2 * BK * LDS, "dk/dv staging must fit in the S/dP area");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BK * LD;
  bf16* sQ = sV + BK * LD;
  bf16* sdO = sQ + BQ * LD;
  bf16* sPt = sdO + BQ * LD;
  bf16* sdSt = sPt + BK * LDP;
  float* sSt = reinterpret_cast<float*>(sdSt + BK * LDP);
  float* sdPt = sSt + BK * LDS;
  float* sLse = sdPt + BK * LDS;
  float* sDelta = sLse + BQ;

  // heaviest causal tiles (first k tiles) are scheduled first
  const int ki = blockIdx.x;
  const int bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int g = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int k0 = ki * BK;

  load_tile<D, BK>(sK, k + (size_t)bhk * T * D, k0, T);
  load_tile<D, BK>(sV, v + (size_t)bhk * T * D, k0, T);

  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.f);
    wmma::fill_fragment(dv_acc[j], 0.f);
  }

  const int n_qb = (T + BQ - 1) / BQ;
  const int q_begin = causal ? causal_first_q_tile(ki) : 0;
  for (int hg = 0; hg < g; ++hg) {
    const int bh = b * H + hk * g + hg;
    const bf16* qp = q + (size_t)bh * T * D;
    const bf16* dop = dout + (size_t)bh * T * D;
    for (int qi = q_begin; qi < n_qb; ++qi) {
      const int q0 = qi * BQ;
      __syncthreads();
      load_tile<D, BQ>(sQ, qp, q0, T);
      load_tile<D, BQ>(sdO, dop, q0, T);
      load_rows_f32(sLse, lse + (size_t)bh * T, q0, T);
      load_rows_f32(sDelta, delta + (size_t)bh * T, q0, T);
      __syncthreads();

      warp_abt<D>(sSt + r0 * LDS, sK + r0 * LD, sQ);    // S^T  = K Q^T
      warp_abt<D>(sdPt + r0 * LDS, sV + r0 * LD, sdO);  // dP^T = V dO^T
      __syncwarp();
      for (int i = lane; i < 16 * BQ; i += 32) {
        const int r = r0 + i / BQ, c = i % BQ;
        const int k_idx = k0 + r, q_idx = q0 + c;
        const bool valid = q_idx < T && k_idx < T && (!causal || q_idx >= k_idx);
        const float p = valid ? expf(sSt[r * LDS + c] * scale - sLse[c]) : 0.f;
        sPt[r * LDP + c] = __float2bfloat16(p);
        sdSt[r * LDP + c] = __float2bfloat16(p * (sdPt[r * LDS + c] - sDelta[c]));
      }
      __syncwarp();
      warp_ab_accum<D>(dv_acc, sPt + r0 * LDP, sdO);    // dv += P^T dO
      warp_ab_accum<D>(dk_acc, sdSt + r0 * LDP, sQ);    // dk += dS^T Q
    }
  }
  __syncthreads();

  float* sOut = sSt;
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(sOut + r0 * LDO + j * 16, dk_acc[j], LDO, wmma::mem_row_major);
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int k_idx = k0 + r0 + rr;
    if (k_idx >= T) break;
    bf16* row = dk + ((size_t)bhk * T + k_idx) * D;
    for (int c = lane; c < D; c += 32)
      row[c] = __float2bfloat16(sOut[(r0 + rr) * LDO + c] * scale);
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(sOut + r0 * LDO + j * 16, dv_acc[j], LDO, wmma::mem_row_major);
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int k_idx = k0 + r0 + rr;
    if (k_idx >= T) break;
    bf16* row = dv + ((size_t)bhk * T + k_idx) * D;
    for (int c = lane; c < D; c += 32) row[c] = __float2bfloat16(sOut[(r0 + rr) * LDO + c]);
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
               int Hkv, int T, int causal, float scale, cudaStream_t stream) {
  const size_t smem = FwdSmem<D>::kBytes;
  cudaError_t e = prepare(flash_fwd_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, H, Hkv, T, causal,
      scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int H, int Hkv, int T, int causal, float scale,
              cudaStream_t stream) {
  const size_t smem = DqSmem<D>::kBytes;
  cudaError_t e = prepare(flash_bwd_dq_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (bf16*)dq, H, Hkv, T, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int H, int Hkv, int T, int causal,
               float scale, cudaStream_t stream) {
  const size_t smem = DkvSmem<D>::kBytes;
  cudaError_t e = prepare(flash_bwd_dkv_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + BK - 1) / BK, B * Hkv);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (bf16*)dk, (bf16*)dv, H, Hkv, T, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                   int Hkv, int T, int D, int causal, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64) return launch_fwd<64>(q, k, v, o, lse, B, H, Hkv, T, causal, scale, s);
  if (D == 128) return launch_fwd<128>(q, k, v, o, lse, B, H, Hkv, T, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int B, int H, int Hkv, int T,
                      int D, int causal, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64) return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, H, Hkv, T, causal, scale, s);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, H, Hkv, T, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                       int Hkv, int T, int D, int causal, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, T, causal, scale, s);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, T, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
