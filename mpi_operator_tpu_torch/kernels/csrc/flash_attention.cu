// Flash attention for Hopper (sm_90a): forward (K1), the fused backward
// (K3: dk, dv and dq's f32 sum) and the dq pass that scales and rounds that
// sum; bf16 operands, f32 accumulation.
//
// Replaces the three Pallas TPU kernels of
// mpi_operator_tpu/kernels/flash_attention.py:
//   K1 flash_fwd_kernel     <- _fwd_kernel      (pallas_call in _flash_fwd)
//   K3 flash_bwd_dkv_kernel <- _bwd_dkv_kernel  (second pallas_call in _flash_bwd)
//                              and the products of _bwd_dq_kernel (first pallas_call)
//   flash_bwd_dq_kernel     <- _bwd_dq_kernel's emit (dq = scale * acc, rounded)
//
// What bounds them on this card: operations. At the Llama shape (T=2048,
// D=128) each kernel does ~D/2 tensor-core FLOP per byte it must move, well
// above the H100's ~295 FLOP/byte ridge, so the tensor cores are the limit,
// and the one road to their rate is wgmma fed by TMA. The dq pass alone is
// bound by bytes.
//
// K1 and K3 are built on Hopper's warpgroup MMA (hopper.cuh): two consumer
// warpgroups of 64 rows each per CTA, every accumulator in registers, tiles
// brought by TMA (128-byte swizzle, started by thread 0) into a 2-stage ring
// whose "full" mbarriers count the bytes in, so the next tile's copy
// overlaps this tile's products. A stage is refilled once both warpgroups
// are done with it: K1 counts that on "empty" mbarriers, K3 has a CTA
// barrier per tile anyway (for lse/delta) and refills after it. Scores and
// probabilities never touch shared memory: an m64nN f32 accumulator maps in
// place onto the bf16 register A operand of the next product
// (hopper::acc_to_a). K3 also stores bf16 dS into shared memory, once, for
// dQ's product.
//
// Design notes against the TPU kernels:
// - The TPU grid runs in order and carries (acc, m, l) in VMEM scratch across
//   the innermost grid axis. Here that axis is a loop inside the CTA, and the
//   grid covers (q tile, b*h) for K1 and (k tile, b*h_kv) for K3.
// - The TPU backward is two kernels, each recomputing S = Q.K^T and dP =
//   dO.V^T for every tile pair: dq's grid carries its sum over k tiles in
//   VMEM. Here one kernel on the k-tile grid computes S and dP once and adds
//   each tile pair's dQ share into an f32 [B,H,T,D] accumulator with TMA
//   reduce-adds, the cross-CTA sum this card does in L2; the order of those
//   adds, and so dQ's f32 rounding, is not fixed from run to run.
// - Causal tile skipping is a loop bound from the same algebra as
//   _causal_last_k_tile / _causal_first_q_tile, not a clamp of an index map;
//   the heaviest tiles are scheduled first.
// - The TPU wrappers zero-pad T to block multiples. Here every tile comes
//   through a 3-D tensor map (D, T, B*heads), so TMA zero-fills rows past T
//   instead of reading the next head, and drops them from a reduce-add; the
//   score mask (k < T) keeps them out, and rows past T are never stored.
// - K3 loops over the g q-heads of a kv head inside the CTA and sums their
//   dk/dv in f32 registers: no per-q-head [B,H,T,D] partials, no atomics.
// - Rounding points match the TPU kernels: P is rounded to bf16 before P.V,
//   dS to bf16 before its products, dq/dk scaled by `scale` when emitted.
//   Both take exp as exp2 with scale*log2(e) folded into one multiply
//   (the plain versions use exp; the two differ by f32 rounding only).
//
// Plain C interface (loaded with ctypes): every launcher returns
// cudaGetLastError() right after its launch, and the Python wrapper raises on
// anything but 0. Layouts are contiguous: q/o/dO/dq [B,H,T,D], k/v/dk/dv
// [B,Hkv,T,D], lse/delta [B,H,T] f32, dq's accumulator [B,H,T,D] f32,
// D in {16, 32, 64, 128}.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr float NEG_INF = -1e30f;  // large-negative, not -inf: exp() stays NaN-free
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// _causal_last_k_tile: largest ki whose tile meets q tile qi's causal region.
template <int TQ, int TK>
__device__ __forceinline__ int causal_last_k_tile(int qi) {
  return ((qi + 1) * TQ + TK - 1) / TK - 1;
}

// _causal_first_q_tile: smallest qi whose tile meets k tile ki's causal region.
template <int TQ, int TK>
__device__ __forceinline__ int causal_first_q_tile(int ki) {
  return (ki * TK) / TQ;
}

// dynamic shared memory, moved up to the 1024-byte boundary the 128-byte
// swizzle needs (the launch asks for 1024 bytes more than the layout)
__device__ __forceinline__ unsigned char* align_smem(unsigned char* raw) {
  return raw + ((1024u - (hopper::smem_u32(raw) & 1023u)) & 1023u);
}

// The shared-memory tile width of a head dim: D 64 and 128 as they are;
// D 16 and 32 in the D-64 tiles, whose columns past D the TMA box zero-fills
// (the tensor map's inner extent is D), so Q.K^T and dO.V^T skip the zero
// k16 steps (DH / 16 of them), P.V and the other products whose N is the
// head dim run at N = 64 on zero columns, and only DH columns are stored.
__host__ __device__ constexpr int tile_d(int dh) { return dh < 64 ? 64 : dh; }

constexpr int WG_THREADS = 128;          // one warpgroup
constexpr int WG_CTA = 2 * WG_THREADS;   // two consumer warpgroups per CTA

constexpr int FWD_BQ = 128;  // K1: q rows per CTA, 64 per warpgroup
constexpr int FWD_BK = 128;  // K1: k rows per stage of the ring
constexpr int DKV_BK = 128;  // K3: k rows per CTA, 64 per warpgroup
constexpr int DKV_BQ = 64;   // K3: q rows per stage of the ring
constexpr int DQ_BOX = 32;   // K3: f32 columns of a dQ reduce box (128 bytes)

template <int D> struct FwdSmem {
  static constexpr int kQ = FWD_BQ * D * 2;   // Q tile, bytes
  static constexpr int kKV = FWD_BK * D * 2;  // one K or V tile
  static constexpr int kStage = 2 * kKV;      // K then V
  static constexpr size_t kBytes = 1024 + kQ + 2 * kStage + 8 * 8;
};

// K1. CTA (q tile of 128 rows, b*h); warpgroup w owns rows 64w..64w+63 and
// walks the k tiles with the online softmax in registers: S = Q.K^T (both
// operands in shared memory), P = exp2(S - m) rounded to bf16 in place as
// the A operand of O += P.V (V read MN-major). Each accumulator row lives in
// the 4 threads of a quad: two shuffles for the max, two for the final sum.
template <int DH>
__global__ void __launch_bounds__(WG_CTA, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int T, int causal, float scale_log2) {
  constexpr int D = tile_d(DH);
  using L = FwdSmem<D>;
  constexpr int NC = D / 64;  // 64-wide column blocks of a row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + L::kQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 2 * L::kStage);  // [2] tile landed
  uint64_t* empty = full + 2;  // [2] all 8 warps done with the stage
  uint64_t* qbar = full + 4;

  const int qi = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int bhk = b * Hkv + h / (H / Hkv);
  const int q0 = qi * FWD_BQ;
  const int n_kb = (T + FWD_BK - 1) / FWD_BK;
  const int k_end = causal ? min(n_kb, causal_last_k_tile<FWD_BQ, FWD_BK>(qi) + 1) : n_kb;
  const int tid = threadIdx.x, wg = tid / WG_THREADS, lane = tid % 32;
  const int warp_row = wg * 64 + (tid % WG_THREADS) / 32 * 16;  // warp's first row in the tile
  const int row = q0 + warp_row + lane / 4;  // q of accumulator registers i with i % 4 < 2; +8 else

  auto stage_k = [&](int s) { return reinterpret_cast<bf16*>(ring + s * L::kStage); };
  auto stage_v = [&](int s) { return reinterpret_cast<bf16*>(ring + s * L::kStage + L::kKV); };
  auto load_kv = [&](int j) {
    const int s = j & 1;
    hopper::mbar_expect_tx(&full[s], L::kStage);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      hopper::tma_load_3d(stage_k(s) + c * FWD_BK * 64, &tm_k, &full[s], c * 64, j * FWD_BK, bhk);
      hopper::tma_load_3d(stage_v(s) + c * FWD_BK * 64, &tm_v, &full[s], c * 64, j * FWD_BK, bhk);
    }
  };

  if (tid == 0) {
    hopper::mbar_init(&full[0], 1);
    hopper::mbar_init(&full[1], 1);
    hopper::mbar_init(&empty[0], 2 * WG_THREADS / 32);
    hopper::mbar_init(&empty[1], 2 * WG_THREADS / 32);
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(qbar, L::kQ);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      hopper::tma_load_3d(sQ + c * FWD_BQ * 64, &tm_q, qbar, c * 64, q0, bh);
    load_kv(0);
    if (k_end > 1) load_kv(1);
  }

  float acc_o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max of rows row, row + 8, in log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the running sums
  const bf16* sQw = sQ + wg * 64 * 64;  // this warpgroup's rows in each column block
  hopper::mbar_wait(qbar, 0);

  for (int j = 0; j < k_end; ++j) {
    const int s = j & 1;
    hopper::mbar_wait(&full[s], (j >> 1) & 1);
    float acc_s[FWD_BK / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      hopper::Wgmma<FWD_BK>::ss(acc_s, hopper::desc_k_major<FWD_BQ>(sQw, kk),
                                hopper::desc_k_major<FWD_BK>(stage_k(s), kk), kk > 0);
    hopper::wgmma_commit();
    // while S computes: refill the stage of tile j-1 with tile j+1 once
    // both warpgroups have released it
    if (tid == 0 && j >= 1 && j + 1 < k_end) {
      hopper::mbar_wait(&empty[(j - 1) & 1], ((j - 1) >> 1) & 1);
      load_kv(j + 1);
    }
    __syncwarp();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc_s);

    const int k0 = j * FWD_BK;
    const bool mask = k0 + FWD_BK > T || (causal && k0 + FWD_BK - 1 > q0 + warp_row);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < FWD_BK / 2; ++i) {
      float x = acc_s[i] * scale_log2;
      if (mask) {
        const int col = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        if (col >= T || (causal && col > row + 8 * ((i / 2) % 2))) x = NEG_INF;
      }
      acc_s[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < FWD_BK / 2; ++i) {
      const float p = exp2f(acc_s[i] - m[(i / 2) % 2]);
      l[(i / 2) % 2] += p;  // the f32 p, before its bf16 rounding
      acc_s[i] = p;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_o[i] *= corr[(i / 2) % 2];
    uint32_t a_p[FWD_BK / 16][4];
    hopper::acc_to_a(acc_s, a_p);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FWD_BK / 16; ++kk)
      hopper::Wgmma<D>::template rs<1>(acc_o, a_p[kk], hopper::desc_mn_major<FWD_BK>(stage_v(s), kk),
                                       1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc_o);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // emit; fully masked rows (l == 0) give o = 0, not NaN
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = (l[r] == 0.f) ? 1.f : l[r];
  }
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = row + 8 * ((i / 2) % 2);
    if (8 * (i / 4) < DH && r < T) {
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)bh * T + r) * DH + col) =
          __floats2bfloat162_rn(acc_o[i] / l[(i / 2) % 2], acc_o[i + 1] / l[(i / 2) % 2]);
    }
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row + 8 * r < T) lse[(size_t)bh * T + row + 8 * r] = m[r] * LN2 + logf(l[r]);
  }
}

template <int D> struct DkvSmem {
  static constexpr int kKV = DKV_BK * D * 2;       // K or V, bytes
  static constexpr int kQ = DKV_BQ * D * 2;        // a Q or dO tile
  static constexpr int kStage = 2 * kQ;            // Q then dO
  static constexpr int kDs = DKV_BK * DKV_BQ * 2;  // bf16 dS^T of a tile pair
  static constexpr int kBox = DKV_BQ * DQ_BOX * 4; // one f32 reduce box of dQ
  static constexpr int kDq = 2 * kBox;             // a warpgroup's dQ share: 64 columns
  static constexpr int kRows = 2 * DKV_BQ * 4;     // lse then delta of a q tile
  static constexpr size_t kBytes =
      1024 + 2 * kKV + 2 * kStage + kDs + 4 * kDq + 2 * kRows + 8 * 8;
};

// K3, replacing both _bwd_dkv_kernel and the products of _bwd_dq_kernel.
// CTA (k tile of 128 rows, b*h_kv); warpgroup w owns k rows 64w..64w+63,
// loads its K and V once, and walks every (q head of the group, q tile of 64
// from causal_first_q_tile) through the ring, which brings Q and dO. lse and
// delta (64 floats each a tile) do not come by TMA, whose boxes must start
// 16-byte aligned, which a row of them does not at every T: one thread per
// value loads them a tile ahead into a register and stores them into a
// double-buffered slot behind one CTA barrier per tile. In the transposed
// form S^T = K.Q^T and dP^T = V.dO^T come out with k on the rows, so P^T and
// dS^T are register A operands of dV += P^T.dO and dK += dS^T.Q, with dO and
// Q read MN-major. dK and dV stay f32 registers over the whole group: no
// atomics, no [B,H,T,D] transient.
// dQ from the same S and dP: both warpgroups store bf16(dS^T) (the rounding
// of dK's operand) into one swizzled [128 k, 64 q] tile, and after a CTA
// barrier dQ_tile = dS.K runs as an all-shared-memory wgmma, dS read M-major
// and K N-major: at D 128 warpgroup w takes D columns 64w..64w+63; at D <= 64
// one warpgroup takes the tile, in turn by its parity. The f32 product goes
// into a double-buffered swizzled staging slot and one thread adds it into
// the f32 accumulator [B,H,T,D] with TMA reduce-adds (boxes of 64 rows x 32
// columns; rows past T and columns past D dropped by the tensor map). The
// slot is refilled two of the warpgroup's tiles later, after its thread's
// bulk group has been read. Bound by operations: five products of 2*D FLOP
// per (q, k) pair (S^T, dP^T, dV, dK, dQ). The reduce-adds' order across k
// tiles, and so dQ's f32 rounding, is not fixed from run to run; dq is
// scaled and rounded by flash_bwd_dq_kernel.
template <int DH>
__global__ void __launch_bounds__(WG_CTA, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_dq, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
                     int H, int Hkv, int T, int causal, float scale, float scale_log2) {
  constexpr int D = tile_d(DH);
  using L = DkvSmem<D>;
  constexpr int NC = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::kKV);
  unsigned char* ring = smem + 2 * L::kKV;
  unsigned char* sdS = ring + 2 * L::kStage;  // [128 k, 64 q] bf16, swizzled
  unsigned char* sdQ = sdS + L::kDs;          // [warpgroup][slot] of kDq
  float* rows = reinterpret_cast<float*>(sdQ + 4 * L::kDq);  // [2][lse 64, delta 64]
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(rows) +
                                               2 * L::kRows);  // [2]
  uint64_t* kvbar = full + 2;

  const int ki = blockIdx.x;  // heaviest causal tiles (first k tiles) first
  const int bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int g = H / Hkv;
  const int k0 = ki * DKV_BK;
  const int n_qb = (T + DKV_BQ - 1) / DKV_BQ;
  const int q_begin = causal ? causal_first_q_tile<DKV_BQ, DKV_BK>(ki) : 0;
  const int nq = n_qb - q_begin;
  const int n_tiles = g * nq;  // (q head, q tile) pairs, q tiles innermost
  const int tid = threadIdx.x, wg = tid / WG_THREADS, lane = tid % 32;
  const bool leader = tid % WG_THREADS == 0;  // issues the warpgroup's reduce-adds
  const int warp_row = wg * 64 + (tid % WG_THREADS) / 32 * 16;
  const int row = k0 + warp_row + lane / 4;  // k of accumulator registers i with i % 4 < 2; +8 else

  auto stage_q = [&](int s) { return reinterpret_cast<bf16*>(ring + s * L::kStage); };
  auto stage_do = [&](int s) { return reinterpret_cast<bf16*>(ring + s * L::kStage + L::kQ); };
  auto load_q = [&](int j) {
    const int s = j & 1;
    const int bh = b * H + hk * g + j / nq;
    const int q0 = (q_begin + j % nq) * DKV_BQ;
    hopper::mbar_expect_tx(&full[s], L::kStage);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      hopper::tma_load_3d(stage_q(s) + c * DKV_BQ * 64, &tm_q, &full[s], c * 64, q0, bh);
      hopper::tma_load_3d(stage_do(s) + c * DKV_BQ * 64, &tm_do, &full[s], c * 64, q0, bh);
    }
  };

  if (tid == 0) {
    hopper::mbar_init(&full[0], 1);
    hopper::mbar_init(&full[1], 1);
    hopper::mbar_init(kvbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(kvbar, 2 * L::kKV);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      hopper::tma_load_3d(sK + c * DKV_BK * 64, &tm_k, kvbar, c * 64, k0, bhk);
      hopper::tma_load_3d(sV + c * DKV_BK * 64, &tm_v, kvbar, c * 64, k0, bhk);
    }
    load_q(0);
    if (n_tiles > 1) load_q(1);
  }

  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    acc_dk[i] = 0.f;
    acc_dv[i] = 0.f;
  }
  const bf16* sKw = sK + wg * 64 * 64;  // this warpgroup's rows in each column block
  const bf16* sVw = sV + wg * 64 * 64;
  // dQ's columns: at D 128 this warpgroup's block of K; below, the one block
  const bf16* sKdq = sK + (NC == 2 ? wg : 0) * DKV_BK * 64;
  const int dq_col0 = NC == 2 ? 64 * wg : 0;
  // thread t < 128 carries value t % 64 of lse (t < 64) or delta of a tile; 0 past T
  auto fetch_row = [&](int j) {
    const int q = (q_begin + j % nq) * DKV_BQ + tid % DKV_BQ;
    const float* src = tid < DKV_BQ ? lse : delta;
    return (tid < 2 * DKV_BQ && q < T) ? src[(size_t)(b * H + hk * g + j / nq) * T + q] : 0.f;
  };
  float next_row = fetch_row(0);
  hopper::mbar_wait(kvbar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1;
    const int bh = b * H + hk * g + j / nq;
    const int q0 = (q_begin + j % nq) * DKV_BQ;
    const float* s_lse = rows + s * 2 * DKV_BQ;
    const float* s_delta = s_lse + DKV_BQ;
    const bool dq_mine = NC == 2 || (j & 1) == wg;
    const int turn = NC == 2 ? j : j >> 1;  // this warpgroup's dQ tiles so far
    // the row slot was last read in tile j - 2, which every thread has finished
    if (tid < 2 * DKV_BQ) rows[s * 2 * DKV_BQ + tid] = next_row;
    // the dQ slot this tile fills was last sent two turns ago: read by now
    if (leader) hopper::bulk_wait_read<1>();
    __syncthreads();
    // every thread is done with tile j - 1: refill its stage with tile j + 1
    if (tid == 0 && j >= 1 && j + 1 < n_tiles) load_q(j + 1);
    if (j + 1 < n_tiles) next_row = fetch_row(j + 1);  // lands while this tile computes
    hopper::mbar_wait(&full[s], (j >> 1) & 1);
    float acc_s[DKV_BQ / 2], acc_dp[DKV_BQ / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      hopper::Wgmma<DKV_BQ>::ss(acc_s, hopper::desc_k_major<DKV_BK>(sKw, kk),
                                hopper::desc_k_major<DKV_BQ>(stage_q(s), kk), kk > 0);
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      hopper::Wgmma<DKV_BQ>::ss(acc_dp, hopper::desc_k_major<DKV_BK>(sVw, kk),
                                hopper::desc_k_major<DKV_BQ>(stage_do(s), kk), kk > 0);
    hopper::wgmma_commit();

    const bool mask = q0 + DKV_BQ > T || (causal && q0 < k0 + warp_row + 15);
    hopper::wgmma_wait<1>();  // S^T is in
    hopper::fence_regs(acc_s);
#pragma unroll
    for (int i = 0; i < DKV_BQ / 2; ++i) {
      const int col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      float p = exp2f(fmaf(acc_s[i], scale_log2, -s_lse[col] * LOG2E));
      if (mask) {
        const int q = q0 + col;
        if (q >= T || (causal && q < row + 8 * ((i / 2) % 2))) p = 0.f;
      }
      acc_s[i] = p;
    }
    hopper::wgmma_wait<0>();  // dP^T is in
    hopper::fence_regs(acc_dp);
#pragma unroll
    for (int i = 0; i < DKV_BQ / 2; ++i) {
      const int col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      acc_dp[i] = acc_s[i] * (acc_dp[i] - s_delta[col]);  // dS^T, f32
    }
    uint32_t a_p[DKV_BQ / 16][4], a_ds[DKV_BQ / 16][4];
    hopper::acc_to_a(acc_s, a_p);
    hopper::acc_to_a(acc_dp, a_ds);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DKV_BQ / 16; ++kk)
      hopper::Wgmma<D>::template rs<1>(acc_dv, a_p[kk],
                                       hopper::desc_mn_major<DKV_BQ>(stage_do(s), kk), 1);
#pragma unroll
    for (int kk = 0; kk < DKV_BQ / 16; ++kk)
      hopper::Wgmma<D>::template rs<1>(acc_dk, a_ds[kk],
                                       hopper::desc_mn_major<DKV_BQ>(stage_q(s), kk), 1);
    hopper::wgmma_commit();
    // bf16(dS^T) into the swizzled tile while dV and dK run: fragment
    // a_ds[kk][e] is k row warp_row + lane/4 + 8(e%2), q columns
    // 16kk + 8(e/2) + 2(lane%4) and one more, in 16-byte chunk 2kk + e/2
#pragma unroll
    for (int kk = 0; kk < DKV_BQ / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = warp_row + lane / 4 + 8 * (e % 2);
        *reinterpret_cast<uint32_t*>(sdS + r * 128 + (((2 * kk + e / 2) ^ (lane / 4)) << 4) +
                                     4 * (lane % 4)) = a_ds[kk][e];
      }
    hopper::fence_proxy_async();
    __syncthreads();  // both warpgroups' halves of dS are in
    float acc_dq[32];
    if (dq_mine) {
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DKV_BK / 16; ++kk)
        hopper::Wgmma<64>::ss<1, 1>(acc_dq, hopper::desc_mn_major<DKV_BK>(
                                                reinterpret_cast<const bf16*>(sdS), kk),
                                    hopper::desc_mn_major<DKV_BK>(sKdq, kk), kk > 0);
      hopper::wgmma_commit();
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc_dv);
    hopper::fence_regs(acc_dk);
    if (dq_mine) {
      hopper::fence_regs(acc_dq);
      // rows are q: warp_row % 64 + lane/4 (+8); columns 8(i/4) + 2(lane%4)
      // (+1), box i/16, 16-byte chunk 2((i/4)%4) + (lane%4)/2 of a 128-byte row
      unsigned char* slot = sdQ + (wg * 2 + (turn & 1)) * L::kDq;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = warp_row % 64 + lane / 4 + 8 * ((i / 2) % 2);
        const int chunk = 2 * ((i / 4) % 4) + (lane % 4) / 2;
        *reinterpret_cast<float2*>(slot + (i / 16) * L::kBox + r * 128 +
                                   ((chunk ^ (lane / 4)) << 4) + 8 * (lane % 2)) =
            make_float2(acc_dq[i], acc_dq[i + 1]);
      }
      hopper::fence_proxy_async();
      hopper::bar_sync(1 + wg, WG_THREADS);
      if (leader) {
#pragma unroll
        for (int x = 0; x < 2; ++x)
          if (dq_col0 + x * DQ_BOX < DH)
            hopper::tma_reduce_add_3d(&tm_dq, slot + x * L::kBox, dq_col0 + x * DQ_BOX, q0, bh);
        hopper::bulk_commit();
      }
    }
  }
  if (leader) hopper::bulk_wait<0>();

#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = row + 8 * ((i / 2) % 2);
    if (8 * (i / 4) < DH && r < T) {
      const size_t at = ((size_t)bhk * T + r) * DH + 8 * (i / 4) + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(acc_dk[i] * scale, acc_dk[i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) = __floats2bfloat162_rn(acc_dv[i], acc_dv[i + 1]);
    }
  }
}

// The dq pass, what is left of the dq kernel: dq = bf16(scale * acc) over
// the f32 accumulator that K3's reduce-adds filled, four values a thread a
// step. Bound by bytes (4 in, 2 out per value); n is a multiple of 4 (D is).
__global__ void __launch_bounds__(256)
flash_bwd_dq_kernel(const float4* __restrict__ acc, uint2* __restrict__ dq, size_t n4, float scale) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 a = acc[i];
    __nv_bfloat162 lo = __floats2bfloat162_rn(a.x * scale, a.y * scale);
    __nv_bfloat162 hi = __floats2bfloat162_rn(a.z * scale, a.w * scale);
    dq[i] = make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
  }
}

// Layout probe for the card tests: one warpgroup computes S = A.B^T (A [64,D]
// and B [N,D] K-major from TMA tiles) and O = bf16(S).V (V [N,D] read
// MN-major, bf16(S) the register A operand in place), the two operand paths
// K1-K3 are built from. S and O are written in f32.
template <int N, int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
wgmma_probe_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                   const __grid_constant__ CUtensorMap tm_v, float* __restrict__ s_out,
                   float* __restrict__ o_out) {
  constexpr int NC = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + 64 * D;
  bf16* sV = sB + N * D;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sV + N * D);
  const int tid = threadIdx.x, lane = tid % 32;
  const int row = tid / 32 * 16 + lane / 4;
  if (tid == 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(bar, (64 + 2 * N) * D * 2);
    for (int c = 0; c < NC; ++c) {
      hopper::tma_load_3d(sA + c * 64 * 64, &tm_a, bar, c * 64, 0, 0);
      hopper::tma_load_3d(sB + c * N * 64, &tm_b, bar, c * 64, 0, 0);
      hopper::tma_load_3d(sV + c * N * 64, &tm_v, bar, c * 64, 0, 0);
    }
  }
  hopper::mbar_wait(bar, 0);
  float acc_s[N / 2];
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::Wgmma<N>::ss(acc_s, hopper::desc_k_major<64>(sA, kk), hopper::desc_k_major<N>(sB, kk),
                         kk > 0);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc_s);
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    s_out[(row + 8 * ((i / 2) % 2)) * N + 8 * (i / 4) + 2 * (lane % 4) + i % 2] = acc_s[i];
  uint32_t a[N / 16][4];
  hopper::acc_to_a(acc_s, a);
  float acc_o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    hopper::Wgmma<D>::template rs<1>(acc_o, a[kk], hopper::desc_mn_major<N>(sV, kk), 1);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc_o);
#pragma unroll
  for (int i = 0; i < D / 2; ++i)
    o_out[(row + 8 * ((i / 2) % 2)) * D + 8 * (i / 4) + 2 * (lane % 4) + i % 2] = acc_o[i];
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DH>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
               int Hkv, int T, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t e;
  if ((e = hopper::tmap_rows_bf16(&tq, q, B * H, T, DH, FWD_BQ)) != cudaSuccess) return (int)e;
  if ((e = hopper::tmap_rows_bf16(&tk, k, B * Hkv, T, DH, FWD_BK)) != cudaSuccess) return (int)e;
  if ((e = hopper::tmap_rows_bf16(&tv, v, B * Hkv, T, DH, FWD_BK)) != cudaSuccess) return (int)e;
  const size_t smem = FwdSmem<tile_d(DH)>::kBytes;
  if ((e = prepare(flash_fwd_kernel<DH>, smem)) != cudaSuccess) return (int)e;
  dim3 grid((T + FWD_BQ - 1) / FWD_BQ, B * H);
  flash_fwd_kernel<DH><<<grid, WG_CTA, smem, stream>>>(tq, tk, tv, (bf16*)o, (float*)lse, H, Hkv,
                                                      T, causal, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dq_acc, void* dk, void* dv, int B, int H, int Hkv, int T,
               int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tdq;
  cudaError_t e;
  if ((e = hopper::tmap_rows_bf16(&tq, q, B * H, T, DH, DKV_BQ)) != cudaSuccess) return (int)e;
  if ((e = hopper::tmap_rows_bf16(&tdo, dout, B * H, T, DH, DKV_BQ)) != cudaSuccess) return (int)e;
  if ((e = hopper::tmap_rows_bf16(&tk, k, B * Hkv, T, DH, DKV_BK)) != cudaSuccess) return (int)e;
  if ((e = hopper::tmap_rows_bf16(&tv, v, B * Hkv, T, DH, DKV_BK)) != cudaSuccess) return (int)e;
  if ((e = hopper::tmap_rows_f32(&tdq, dq_acc, B * H, T, DH, DKV_BQ)) != cudaSuccess) return (int)e;
  const size_t smem = DkvSmem<tile_d(DH)>::kBytes;
  if ((e = prepare(flash_bwd_dkv_kernel<DH>, smem)) != cudaSuccess) return (int)e;
  dim3 grid((T + DKV_BK - 1) / DKV_BK, B * Hkv);
  flash_bwd_dkv_kernel<DH><<<grid, WG_CTA, smem, stream>>>(
      tq, tk, tv, tdo, tdq, (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, H, Hkv,
      T, causal, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int N, int D>
int launch_probe(const void* a, const void* b, const void* v, void* s, void* o,
                 cudaStream_t stream) {
  CUtensorMap ta, tb, tv;
  cudaError_t e;
  if ((e = hopper::tmap_rows_bf16(&ta, a, 1, 64, D, 64)) != cudaSuccess) return (int)e;
  if ((e = hopper::tmap_rows_bf16(&tb, b, 1, N, D, N)) != cudaSuccess) return (int)e;
  if ((e = hopper::tmap_rows_bf16(&tv, v, 1, N, D, N)) != cudaSuccess) return (int)e;
  const size_t smem = 1024 + (64 + 2 * N) * D * 2 + 8;
  if ((e = prepare(wgmma_probe_kernel<N, D>, smem)) != cudaSuccess) return (int)e;
  wgmma_probe_kernel<N, D><<<1, WG_THREADS, smem, stream>>>(ta, tb, tv, (float*)s, (float*)o);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                   int Hkv, int T, int D, int causal, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 16) return launch_fwd<16>(q, k, v, o, lse, B, H, Hkv, T, causal, scale, s);
  if (D == 32) return launch_fwd<32>(q, k, v, o, lse, B, H, Hkv, T, causal, scale, s);
  if (D == 64) return launch_fwd<64>(q, k, v, o, lse, B, H, Hkv, T, causal, scale, s);
  if (D == 128) return launch_fwd<128>(q, k, v, o, lse, B, H, Hkv, T, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// K3: dk, dv and the f32 dq accumulator, which must hold zeros (its
// reduce-adds add into it)
int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dq_acc, void* dk, void* dv,
                       int B, int H, int Hkv, int T, int D, int causal, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 16)
    return launch_dkv<16>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, Hkv, T, causal, scale, s);
  if (D == 32)
    return launch_dkv<32>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, Hkv, T, causal, scale, s);
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, Hkv, T, causal, scale, s);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, Hkv, T, causal, scale,
                           s);
  return (int)cudaErrorInvalidValue;
}

// the dq pass: dq (bf16) = scale * dq_acc (f32), n values, n % 4 == 0
int flash_bwd_dq_bf16(const void* dq_acc, void* dq, long long n, float scale, void* stream) {
  if (n % 4) return (int)cudaErrorInvalidValue;
  const long long n4 = n / 4;
  const unsigned blocks = (unsigned)(n4 < 256LL * 8192 ? (n4 + 255) / 256 : 8192);
  if (blocks == 0) return 0;
  flash_bwd_dq_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float4*)dq_acc, (uint2*)dq, (size_t)n4, scale);
  return (int)cudaGetLastError();
}

// S = A.B^T (f32 [64, N]) and O = bf16(S).V (f32 [64, D]) through the wgmma
// operand paths of K1-K3; a [64, D], b and v [N, D] bf16
int wgmma_probe_bf16(const void* a, const void* b, const void* v, void* s, void* o, int N, int D,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N == 64 && D == 64) return launch_probe<64, 64>(a, b, v, s, o, st);
  if (N == 64 && D == 128) return launch_probe<64, 128>(a, b, v, s, o, st);
  if (N == 128 && D == 64) return launch_probe<128, 64>(a, b, v, s, o, st);
  if (N == 128 && D == 128) return launch_probe<128, 128>(a, b, v, s, o, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
