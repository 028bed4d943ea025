// Flash-attention backward for Hopper (sm_90a) on the tensor cores, with a
// plain C interface (built by bigdl_tpu_torch/ops/_build.py, bound with
// ctypes in bigdl_tpu_torch/ops/flash_attention.py).
//
// Replaces: bigdl_tpu/ops/flash_attention.py:_bwd_kernel_dkv (K2) and
// _bwd_kernel_dq (K3), the two Pallas TPU kernels of _bwd_pallas.  Same
// function and the same split:
//
//   K2 flash_bwd_dkv — one block per (batch*head, 64-key tile); a loop
//      over the q tiles from the first one that can see the keys
//      (lo = k_start / BQ under causality) accumulates
//        dv += p^T do,   ds = p (do v^T - delta) scale,   dk += ds^T q.
//   K3 flash_bwd_dq  — one block per (batch*head, 64-row q tile); a loop
//      over the key tiles up to the causal horizon (the reference's
//      _causal_hi: last real row / BK + 1, so the diagonal tile is kept)
//      accumulates dq += ds k.
//
// Both recompute p = exp(s - lse) from the lse the forward saved, with
// s = (q k^T) * scale: the backward scales the scores, not q, so
// dk = ds^T q takes the unscaled q and ds carries the second factor of
// scale (reference lines 306 and 313-314).  A key that is masked (a future
// key, or one past Sk) or a q row past Sq is dropped by a select AFTER the
// exp, as the reference's jnp.where(mask, p, 0) does: its raw score may
// exceed the row's lse, exp() may then be inf, and inf * 0 would be NaN.
// Rows past Sq are staged with lse = delta = 0.  delta = sum_d do * out
// (fp32, one value per q row) is computed by the caller, as the reference
// leaves it to XLA.
//
// No atomics: every output element is written by exactly one block, which
// sums its terms in a fixed order, so the gradients are the same bits from
// run to run.
//
// Bounds on an H100 SXM.  At the training shape (B=8, H=6, S=512, D=128,
// causal, fp32) K2 does 8 D FLOP per attended (q, k) pair, 6.5 GFLOP,
// 0.096 ms at the 67 TFLOP/s of the CUDA cores, against ~76 MB (~0.023 ms
// at 3.35 TB/s); K3 does 6 D per pair, 4.8 GFLOP, 0.072 ms.  On the tensor
// cores the fp32 contract costs three TF32 products for each one, so the
// floors there are 3 x FLOP / 495 TFLOP/s: 0.039 ms (K2), 0.029 ms (K3).
//
// Design: flash_fwd.cu's (K1) on the tensor cores, with its helpers
// (flash_mma.cuh).
//   * A block is 4 warps; each warp owns 16 rows of the block's 64 (q rows
//     in K3, keys in K2), so the two score-shaped products of an inner
//     tile land in MMA accumulator fragments with the warp's rows as M:
//       K3: S = Q K^T,  dP = dO V^T   (A: Q, dO rows; B: K, V rows)
//       K2: S^T = K Q^T, dP^T = V dO^T (A: K, V rows; B: Q, dO rows)
//     and the gradient products take S or dS from those fragments as their
//     A operand, with the inner tile's rows as B:
//       K3: dQ += dS K;  K2: dV += P^T dO, dK += dS^T Q.
//     Nothing is transposed through shared memory.  p and ds are formed in
//     registers: K3 keeps the lse and delta of the thread's two q rows in
//     registers; in K2 they belong to the q columns 2t, 2t+1 of each 8-wide
//     chunk and are staged with the q tile.
//   * f32: split TF32 on mma.m16n8k8.tf32 as in K1: hi = tf32_rna(x),
//     lo = x - hi read truncated, lo*hi + hi*lo then hi*hi, each pass over
//     several accumulators.  Operands stay raw in shared memory and are
//     split as their fragments load.  The gradient products take A from
//     the accumulator by the permuted contraction (A columns t, t+4 take
//     accumulator columns 2t, 2t+1; B takes rows 2t, 2t+1 of the tile).
//   * bf16: mma.m16n8k16.bf16.  S and dP are exact products with fp32 sums;
//     P and dS stay fp32, as in the reference, and are split into bf16
//     hi + lo for the gradient products, whose B operands (contraction down
//     the rows of a shared tile) come from ldmatrix.trans.
//   * Accuracy: the tensor cores add into their fp32 accumulator with the
//     low bits cut, not rounded, so a sum chained through many MMAs drifts
//     toward zero.  Chained through a whole 512-row loop that cost up to
//     4.3e-5 on O(1)-O(10) gradients (H100), near the 2e-5 + 2e-5 |x|
//     limit.  So every product is summed in fresh accumulators, 32 columns
//     of D at a time for S and dP and one inner tile at a time for the
//     gradients, and added to the running sums with IEEE round-to-nearest:
//     8.6e-6 at the training shape (the SIMT kernels read 9.5e-7).
//   * The block's own 64 rows of two operands land once with cp.async; the
//     inner tiles of the other two follow with cp.async, in a two-stage
//     ring (tile i+1 loads while tile i is computed) or, at f32 D = 128,
//     one stage of 32 rows, which timed faster on an H100 than rings of
//     16-row tiles at two blocks an SM (K3 0.131 against 0.164 ms, K2
//     0.183 against 0.193) and than rings of 32-row tiles at one block an
//     SM (K3 0.137, K2 0.237).  Copies are 16-byte cp.async.cg when q, k,
//     v, do and all their strides are 16-byte aligned, 4-byte cp.async.ca
//     otherwise (decided on the host for each call).  Rows past Sq or Sk
//     are zero-filled.
//   * Heavy causal tiles first (K3: high q tiles; K2: low key tiles), and
//     a warp skips the products of an inner tile that none of its rows can
//     see (exact: p would be 0 there).
//   * Dynamic shared memory: f32 D=128 99 KB (one stage of 32 keys or q
//     rows), f32 D=64 102 KB (K3, 64 keys) and 69 KB (K2, 32 q rows),
//     bf16 D=128 (K3 32 keys, K2 16 q rows) 68 and 51 KB, bf16 D=64 54 and
//     36 KB: two blocks (8 warps) an SM or more.
//
// ptxas -v (nvcc 12.9, sm_90a), registers: f32 D=128 K2 255, K3 219;
// f32 D=64 K2 213, K3 195; bf16 D=128 K2 234, K3 166; bf16 D=64 K2 161,
// K3 162; no instantiation spills (chip_smoke.py fails on a spill).
#include "flash_mma.cuh"

namespace {

using namespace fmma;

constexpr int BR = 64;          // rows a block owns: q rows (K3), keys (K2)
constexpr int NW = 4;           // warps per block, 16 rows each
constexpr int NT = NW * 32;

template <typename T, int D> struct Tile;
// DP: row stride of the shared tiles, in elements (conflict-free fragment
// loads and ldmatrix); BK: keys of K3's inner tile, KS: its stages (1: the
// next tile loads after this one is used; 2: a ring); BQ, QS: the same
// for K2's inner tile of q rows
template <> struct Tile<float, 128> {
    static constexpr int DP = 132, BK = 32, KS = 1, BQ = 32, QS = 1; };
template <> struct Tile<float, 64> {
    static constexpr int DP = 68, BK = 64, KS = 2, BQ = 32, QS = 2; };
template <> struct Tile<__nv_bfloat16, 128> {
    static constexpr int DP = 136, BK = 32, KS = 2, BQ = 16, QS = 2; };
template <> struct Tile<__nv_bfloat16, 64> {
    static constexpr int DP = 72, BK = 64, KS = 2, BQ = 32, QS = 2; };

// element strides: (batch, head, seq) of q, k, v, do, dq, dk, dv
enum { SQ = 0, SK = 3, SV = 6, SDO = 9, SDQ = 12, SDK = 15, SDV = 18 };

struct Args {
    const void* q;
    const void* k;
    const void* v;
    const void* dout;
    const float* lse;       // (B, H, Sq) contiguous
    const float* delta;     // (B, H, Sq) contiguous
    void* dq;
    void* dk;
    void* dv;
    int H, Sq, Sk;
    int64_t st[21];
    float scale;
    int causal;
    int vec16;
};

template <typename T, int D>
constexpr size_t dq_smem() {            // Q, dO once; K, V: KS stages
    constexpr int DP = Tile<T, D>::DP, BK = Tile<T, D>::BK;
    return sizeof(T) * (size_t(2 * BR) * DP +
                        size_t(2 * Tile<T, D>::KS * BK) * DP);
}

template <typename T, int D>
constexpr size_t dkv_smem() {           // K, V once; Q, dO, lse, delta:
    constexpr int DP = Tile<T, D>::DP, BQ = Tile<T, D>::BQ;   // QS stages
    constexpr int QS = Tile<T, D>::QS;
    return sizeof(T) * (size_t(2 * BR) * DP + size_t(2 * QS * BQ) * DP) +
           sizeof(float) * 2 * QS * BQ;
}

template <int NC>
__device__ __forceinline__ void zero(float (*a)[4]) {
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[n][e] = 0.0f;
}

// c1 += A1 B1^T and c2 += A2 B2^T over the D columns: the warp's 16 rows
// of sA1, sA2 against the N rows of sB1, sB2 (the score-shaped products).
// f32: split TF32, each operand split as its fragment loads; each 32
// columns are summed in fresh accumulators and added to c1, c2 (see
// accumulate() for why).
template <int D, int DP, int N>
__device__ __forceinline__ void row_products(float (*c1)[4], float (*c2)[4],
                                             const float* sA1,
                                             const float* sA2,
                                             const float* sB1,
                                             const float* sB2, int w, int g,
                                             int t) {
    const float* a1 = sA1 + (16 * w + g) * DP + t;
    const float* a2 = sA2 + (16 * w + g) * DP + t;
    constexpr int CG = N <= 32 ? 32 : D;        // columns a group
#pragma unroll 1
    for (int c0 = 0; c0 < D; c0 += CG) {
        float f1[N / 8][4], f2[N / 8][4];
        zero<N / 8>(f1);
        zero<N / 8>(f2);
#pragma unroll 2
        for (int c = c0; c < c0 + CG; c += 8) {
            const float x1[4] = {a1[c], a1[8 * DP + c], a1[c + 4],
                                 a1[8 * DP + c + 4]};
            const float x2[4] = {a2[c], a2[8 * DP + c], a2[c + 4],
                                 a2[8 * DP + c + 4]};
            uint32_t h1[4], l1[4], h2[4], l2[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                split(x1[r], h1[r], l1[r]);
                split(x2[r], h2[r], l2[r]);
            }
            float b1[N / 8][2], b2[N / 8][2];
#pragma unroll
            for (int j = 0; j < N / 8; ++j) {
                const float* r1 = sB1 + (8 * j + g) * DP + c + t;
                const float* r2 = sB2 + (8 * j + g) * DP + c + t;
                b1[j][0] = r1[0];
                b1[j][1] = r1[4];
                b2[j][0] = r2[0];
                b2[j][1] = r2[4];
            }
            mma_3xtf32<N / 8>(f1, h1, l1, b1);
            mma_3xtf32<N / 8>(f2, h2, l2, b2);
        }
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                c1[j][e] += f1[j][e];
                c2[j][e] += f2[j][e];
            }
    }
}

// bf16: exact products, fp32 sums
template <int D, int DP, int N>
__device__ __forceinline__ void row_products(float (*c1)[4], float (*c2)[4],
                                             const __nv_bfloat16* sA1,
                                             const __nv_bfloat16* sA2,
                                             const __nv_bfloat16* sB1,
                                             const __nv_bfloat16* sB2, int w,
                                             int g, int t) {
    const __nv_bfloat16* a1 = sA1 + (16 * w + g) * DP + 2 * t;
    const __nv_bfloat16* a2 = sA2 + (16 * w + g) * DP + 2 * t;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
        const int c = 16 * kc;
        const uint32_t x1[4] = {ld32(a1 + c), ld32(a1 + 8 * DP + c),
                                ld32(a1 + c + 8), ld32(a1 + 8 * DP + c + 8)};
        const uint32_t x2[4] = {ld32(a2 + c), ld32(a2 + 8 * DP + c),
                                ld32(a2 + c + 8), ld32(a2 + 8 * DP + c + 8)};
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
            const __nv_bfloat16* r1 = sB1 + (8 * j + g) * DP + c + 2 * t;
            const __nv_bfloat16* r2 = sB2 + (8 * j + g) * DP + c + 2 * t;
            mma_bf16(c1[j], x1, ld32(r1), ld32(r1 + 8));
            mma_bf16(c2[j], x2, ld32(r2), ld32(r2 + 8));
        }
    }
}

// o[16 x D] += p[16 x N] . sB[N x D], p in the accumulator layout of the
// row products.  f32: the permuted contraction (A column t <- p column 2t,
// A column t+4 <- 2t+1; B rows 2t, 2t+1), G accumulators a pass.  The
// tensor cores add into their fp32 accumulator with the low bits cut,
// not rounded, so a sum chained through every MMA of a 512-row loop
// drifts toward zero (~1e-5 of O(1) gradients on an H100); the tile's
// product is summed in fresh accumulators instead (3 N / 8 MMAs) and added
// to o with IEEE round-to-nearest.
template <int D, int DP, int N, int G>
__device__ __forceinline__ void accumulate(float (*o)[4], const float (*p)[4],
                                           const float* sB, int g, int t) {
    uint32_t phi[N / 8][4], plo[N / 8][4];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
        split(p[j][0], phi[j][0], plo[j][0]);
        split(p[j][2], phi[j][1], plo[j][1]);
        split(p[j][1], phi[j][2], plo[j][2]);
        split(p[j][3], phi[j][3], plo[j][3]);
    }
    const float* br = sB + 2 * t * DP + g;
#pragma unroll
    for (int n0 = 0; n0 < D / 8; n0 += G) {
        float c[G][4];
        zero<G>(c);
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
            float b[G][2];
#pragma unroll
            for (int n = 0; n < G; ++n) {
                b[n][0] = br[8 * j * DP + 8 * (n0 + n)];
                b[n][1] = br[(8 * j + 1) * DP + 8 * (n0 + n)];
            }
            mma_3xtf32<G>(c, phi[j], plo[j], b);
        }
#pragma unroll
        for (int n = 0; n < G; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[n0 + n][e] += c[n][e];
    }
}

// bf16: p split into bf16 hi + lo; B from ldmatrix.trans (lane l gives
// the row address of matrix l / 8: tile row (l % 8) + 8 ((l / 8) % 2),
// column 8 (l / 16) of a 16 x 16 block)
template <int D, int DP, int N, int G>
__device__ __forceinline__ void accumulate(float (*o)[4], const float (*p)[4],
                                           const __nv_bfloat16* sB, int g,
                                           int t) {
    const int lane = threadIdx.x % 32;
    const __nv_bfloat16* bl =
        sB + (lane % 8 + 8 * ((lane / 8) % 2)) * DP + 8 * (lane / 16);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
        const float* s0 = p[2 * kk];
        const float* s1 = p[2 * kk + 1];
        uint32_t phi[4], plo[4];
        split_bf16(s0[0], s0[1], phi[0], plo[0]);
        split_bf16(s0[2], s0[3], phi[1], plo[1]);
        split_bf16(s1[0], s1[1], phi[2], plo[2]);
        split_bf16(s1[2], s1[3], phi[3], plo[3]);
#pragma unroll
        for (int g4 = 0; g4 < D / 16; g4 += 4) {
            uint32_t b[4][4];       // 8 n chunks: b0, b1 of n, then n + 1
#pragma unroll
            for (int n2 = 0; n2 < 4; ++n2)
                ldmatrix_x4_trans(b[n2], bl + 16 * kk * DP + 16 * (g4 + n2));
#pragma unroll
            for (int n2 = 0; n2 < 4; ++n2) {
                mma_bf16(o[2 * (g4 + n2)], plo, b[n2][0], b[n2][1]);
                mma_bf16(o[2 * (g4 + n2) + 1], plo, b[n2][2], b[n2][3]);
            }
#pragma unroll
            for (int n2 = 0; n2 < 4; ++n2) {
                mma_bf16(o[2 * (g4 + n2)], phi, b[n2][0], b[n2][1]);
                mma_bf16(o[2 * (g4 + n2) + 1], phi, b[n2][2], b[n2][3]);
            }
        }
    }
}

// rows r and r + 8 of a 16-row accumulator [16 x D] to global memory
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, int64_t ss, int row,
                                           int n_rows, const float (*a)[4],
                                           int t) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (row + 8 * r >= n_rows) continue;
        T* out = dst + (row + 8 * r) * ss + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
            store2(out + 8 * n, a[n][2 * r], a[n][2 * r + 1]);
    }
}

// K3: one block per (batch*head, 64-row q tile)
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(Args a) {
    constexpr int DP = Tile<T, D>::DP, BK = Tile<T, D>::BK;
    constexpr int KS = Tile<T, D>::KS;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sQ = reinterpret_cast<T*>(smem_raw);
    T* sO = sQ + BR * DP;                       // do
    T* sK = sO + BR * DP;                       // KS stages of BK x DP
    T* sV = sK + KS * BK * DP;                  // KS stages of BK x DP

    const int tid = threadIdx.x;
    const int w = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;   // heavy tiles first
    const int bh = blockIdx.x;
    const int b = bh / a.H, h = bh % a.H;
    const int64_t* st = a.st;
    const T* qp = static_cast<const T*>(a.q) + b * st[SQ] + h * st[SQ + 1];
    const T* kp = static_cast<const T*>(a.k) + b * st[SK] + h * st[SK + 1];
    const T* vp = static_cast<const T*>(a.v) + b * st[SV] + h * st[SV + 1];
    const T* op = static_cast<const T*>(a.dout) + b * st[SDO] +
                  h * st[SDO + 1];
    const int Sq = a.Sq, Sk = a.Sk, causal = a.causal;
    const bool vec16 = a.vec16;

    int n_kt = (Sk + BK - 1) / BK;
    if (causal) n_kt = min(n_kt, (min(q0 + BR, Sq) - 1) / BK + 1);
    // Q, dO (rows past Sq as 0) and key tile 0: one group
    load_tile<T, D, DP, BR, NT>(sQ, qp, st[SQ + 2], q0, Sq, vec16);
    load_tile<T, D, DP, BR, NT>(sO, op, st[SDO + 2], q0, Sq, vec16);
    load_tile<T, D, DP, BK, NT>(sK, kp, st[SK + 2], 0, Sk, vec16);
    load_tile<T, D, DP, BK, NT>(sV, vp, st[SV + 2], 0, Sk, vec16);
    cp_async_commit();

    // this warp's rows: g and g + 8 of its 16, with their lse and delta
    const int row0 = q0 + 16 * w + g;
    const int warp_first = q0 + 16 * w;
    const int warp_last = min(warp_first + 15, Sq - 1);
    float lse[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const bool in = row < Sq;
        lse[r] = in ? a.lse[int64_t(bh) * Sq + row] : 0.0f;
        dlt[r] = in ? a.delta[int64_t(bh) * Sq + row] : 0.0f;
    }
    float acc[D / 8][4];
    zero<D / 8>(acc);

    for (int kt = 0; kt < n_kt; ++kt) {
        const int stg = KS == 2 ? kt & 1 : 0;
        // KS = 2: tile kt + 1 into the other stage; KS = 1: tile kt, once
        // tile kt - 1 is read
        const int nx = KS == 2 ? kt + 1 : (kt > 0 ? kt : n_kt);
        if (nx < n_kt) {
            load_tile<T, D, DP, BK, NT>(sK + (nx & (KS - 1)) * BK * DP, kp,
                                        st[SK + 2], nx * BK, Sk, vec16);
            load_tile<T, D, DP, BK, NT>(sV + (nx & (KS - 1)) * BK * DP, vp,
                                        st[SV + 2], nx * BK, Sk, vec16);
        }
        cp_async_commit();          // an empty group when nothing loads
        if constexpr (KS == 2)
            cp_async_wait1();       // tile kt (and Q, dO) landed: this
        else                        // thread's copies and every thread's
            cp_async_wait0();
        __syncthreads();

        const int k0 = kt * BK;
        const T* kt_s = sK + stg * BK * DP;
        // a warp whose rows all lie before this tile (causal), or past
        // Sq, would only add p = 0: skip its products
        if (warp_first < Sq && !(causal && k0 > warp_last)) {
            float s[BK / 8][4], dp[BK / 8][4];
            zero<BK / 8>(s);
            zero<BK / 8>(dp);
            row_products<D, DP, BK>(s, dp, sQ, sO, kt_s,
                                    sV + stg * BK * DP, w, g, t);
            // a tile before the causal diagonal of every row of the warp
            // and wholly inside Sk has nothing to mask
            const bool masked = k0 + BK > Sk ||
                                (causal && k0 + BK - 1 > warp_first);
#pragma unroll
            for (int j = 0; j < BK / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int qpos = row0 + 8 * (e / 2);
                    const int kpos = k0 + 8 * j + 2 * t + e % 2;
                    float p = expf(s[j][e] * a.scale - lse[e / 2]);
                    if (masked && !(kpos < Sk && (!causal || qpos >= kpos)))
                        p = 0.0f;           // the select after the exp
                    s[j][e] = p * (dp[j][e] - dlt[e / 2]) * a.scale;
                }
            accumulate<D, DP, BK, 8>(acc, s, kt_s, g, t);   // dq += ds k
        }
        __syncthreads();            // stage stg is read: the next load may
    }                               // overwrite it

    T* dqp = static_cast<T*>(a.dq) + b * st[SDQ] + h * st[SDQ + 1];
    store_rows<T, D>(dqp, st[SDQ + 2], row0, Sq, acc, t);
}

// lse and delta of q rows [r0, r0 + BQ) into sL, sD (rows past n as 0)
template <int BQ>
__device__ __forceinline__ void load_rows(float* sL, float* sD,
                                          const float* lp, const float* dp,
                                          int r0, int n) {
    static_assert(2 * BQ <= NT, "one copy a thread");
    const int i = threadIdx.x;
    if (i < 2 * BQ) {
        const int r = i % BQ;
        const bool in = r0 + r < n;
        const float* src = i < BQ ? lp : dp;
        cp_async4((i < BQ ? sL : sD) + r, in ? src + r0 + r : src,
                  in ? 4 : 0);
    }
}

// K2: one block per (batch*head, 64-key tile)
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(Args a) {
    constexpr int DP = Tile<T, D>::DP, BQ = Tile<T, D>::BQ;
    constexpr int QS = Tile<T, D>::QS;
    // dk and dv take D fp32 registers a thread (128 at D = 128): passes
    // over 4 accumulators there leave room for the split operands
    constexpr int G = D == 128 ? 4 : 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sK = reinterpret_cast<T*>(smem_raw);
    T* sV = sK + BR * DP;
    T* sQ = sV + BR * DP;                       // QS stages of BQ x DP
    T* sO = sQ + QS * BQ * DP;                  // do: QS stages of BQ x DP
    float* sL = reinterpret_cast<float*>(sO + QS * BQ * DP);  // lse: QS x BQ
    float* sD = sL + QS * BQ;                   // delta: QS x BQ

    const int tid = threadIdx.x;
    const int w = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int k0 = blockIdx.y * BR;     // low key tiles (the most q) first
    const int bh = blockIdx.x;
    const int b = bh / a.H, h = bh % a.H;
    const int64_t* st = a.st;
    const T* qp = static_cast<const T*>(a.q) + b * st[SQ] + h * st[SQ + 1];
    const T* kp = static_cast<const T*>(a.k) + b * st[SK] + h * st[SK + 1];
    const T* vp = static_cast<const T*>(a.v) + b * st[SV] + h * st[SV + 1];
    const T* op = static_cast<const T*>(a.dout) + b * st[SDO] +
                  h * st[SDO + 1];
    const float* lp = a.lse + int64_t(bh) * a.Sq;
    const float* dlp = a.delta + int64_t(bh) * a.Sq;
    const int Sq = a.Sq, Sk = a.Sk, causal = a.causal;
    const bool vec16 = a.vec16;

    // this warp's keys: g and g + 8 of its 16
    const int key0 = k0 + 16 * w + g;
    const int warp_first = k0 + 16 * w;
    float dk[D / 8][4], dv[D / 8][4];
    zero<D / 8>(dk);
    zero<D / 8>(dv);

    const int n_qt = (Sq + BQ - 1) / BQ;
    const int lo = causal ? k0 / BQ : 0;
    if (lo < n_qt) {
        // K, V (keys past Sk as 0) and q tile lo: one group
        load_tile<T, D, DP, BR, NT>(sK, kp, st[SK + 2], k0, Sk, vec16);
        load_tile<T, D, DP, BR, NT>(sV, vp, st[SV + 2], k0, Sk, vec16);
        load_tile<T, D, DP, BQ, NT>(sQ, qp, st[SQ + 2], lo * BQ, Sq, vec16);
        load_tile<T, D, DP, BQ, NT>(sO, op, st[SDO + 2], lo * BQ, Sq, vec16);
        load_rows<BQ>(sL, sD, lp, dlp, lo * BQ, Sq);
        cp_async_commit();
    }
    for (int qt = lo; qt < n_qt; ++qt) {
        const int stg = QS == 2 ? (qt - lo) & 1 : 0;
        // QS = 2: tile qt + 1 into the other stage; QS = 1: tile qt, once
        // tile qt - 1 is read
        const int nx = QS == 2 ? qt + 1 : (qt > lo ? qt : n_qt);
        if (nx < n_qt) {
            const int sx = (nx - lo) & (QS - 1), r0 = nx * BQ;
            load_tile<T, D, DP, BQ, NT>(sQ + sx * BQ * DP, qp, st[SQ + 2],
                                        r0, Sq, vec16);
            load_tile<T, D, DP, BQ, NT>(sO + sx * BQ * DP, op, st[SDO + 2],
                                        r0, Sq, vec16);
            load_rows<BQ>(sL + sx * BQ, sD + sx * BQ, lp, dlp, r0, Sq);
        }
        cp_async_commit();          // an empty group when nothing loads
        if constexpr (QS == 2)
            cp_async_wait1();       // tile qt (and K, V) landed: this
        else                        // thread's copies and every thread's
            cp_async_wait0();
        __syncthreads();

        const int q0 = qt * BQ;
        const T* q_s = sQ + stg * BQ * DP;
        const T* o_s = sO + stg * BQ * DP;
        // a warp whose keys all lie past Sk, or (causal) after every q row
        // of the tile, would only add p = 0: skip its products
        if (warp_first < Sk && !(causal && warp_first > q0 + BQ - 1)) {
            float s[BQ / 8][4], ds[BQ / 8][4];
            zero<BQ / 8>(s);
            zero<BQ / 8>(ds);
            row_products<D, DP, BQ>(s, ds, sK, sV, q_s, o_s, w, g, t);
            const float* L = sL + stg * BQ;
            const float* Dl = sD + stg * BQ;
            const bool masked = q0 + BQ > Sq || warp_first + 16 > Sk ||
                                (causal && q0 < warp_first + 15);
#pragma unroll
            for (int j = 0; j < BQ / 8; ++j) {
                // lse and delta of q columns 2t and 2t + 1 of chunk j
                const float2 lj =
                    *reinterpret_cast<const float2*>(L + 8 * j + 2 * t);
                const float2 dj =
                    *reinterpret_cast<const float2*>(Dl + 8 * j + 2 * t);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int qpos = q0 + 8 * j + 2 * t + e % 2;
                    const int kpos = key0 + 8 * (e / 2);
                    const float l_c = e % 2 ? lj.y : lj.x;
                    const float d_c = e % 2 ? dj.y : dj.x;
                    float p = expf(s[j][e] * a.scale - l_c);
                    if (masked && !(qpos < Sq && kpos < Sk &&
                                    (!causal || qpos >= kpos)))
                        p = 0.0f;           // the select after the exp
                    s[j][e] = p;
                    ds[j][e] = p * (ds[j][e] - d_c) * a.scale;
                }
            }
            accumulate<D, DP, BQ, G>(dv, s, o_s, g, t);    // dv += p^T do
            accumulate<D, DP, BQ, G>(dk, ds, q_s, g, t);   // dk += ds^T q
        }
        __syncthreads();            // stage stg is read: the next load may
    }                               // overwrite it

    T* dkp = static_cast<T*>(a.dk) + b * st[SDK] + h * st[SDK + 1];
    T* dvp = static_cast<T*>(a.dv) + b * st[SDV] + h * st[SDV + 1];
    store_rows<T, D>(dkp, st[SDK + 2], key0, Sk, dk, t);
    store_rows<T, D>(dvp, st[SDV + 2], key0, Sk, dv, t);
}

template <typename T, int D>
cudaError_t launch(int which, const Args& a, int64_t B, cudaStream_t s) {
    const size_t smem = which == 0 ? dkv_smem<T, D>() : dq_smem<T, D>();
    auto kernel = which == 0 ? flash_bwd_dkv_kernel<T, D>
                             : flash_bwd_dq_kernel<T, D>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    // all of the SM's 228 KB as shared memory: two blocks of up to 110 KB
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return err;
    const int rows = which == 0 ? a.Sk : a.Sq;
    const dim3 grid(unsigned(B * a.H), unsigned((rows + BR - 1) / BR));
    kernel<<<grid, NT, smem, s>>>(a);
    return cudaGetLastError();
}

int copy_bytes4(const void* q, const void* k, const void* v,
                const void* dout, const int64_t* strides, int dtype) {
    const void* ptrs[4] = {q, k, v, dout};
    int64_t st[4][3];
    for (int i = 0; i < 12; ++i) st[i / 3][i % 3] = strides[i];
    return copy_bytes(ptrs, st, 4, dtype == 0 ? 4 : 2);
}

int dispatch(int which, const void* q, const void* k, const void* v,
             const void* dout, const void* lse, const void* delta, void* dq,
             void* dk, void* dv, int64_t B, int64_t H, int64_t Sq,
             int64_t Sk, int64_t D, const int64_t* strides, float scale,
             int causal, int dtype, void* stream) {
    const int bytes = copy_bytes4(q, k, v, dout, strides, dtype);
    if (bytes == 0) return int(cudaErrorMisalignedAddress);
    Args a;
    a.q = q; a.k = k; a.v = v; a.dout = dout;
    a.lse = static_cast<const float*>(lse);
    a.delta = static_cast<const float*>(delta);
    a.dq = dq; a.dk = dk; a.dv = dv;
    a.H = int(H); a.Sq = int(Sq); a.Sk = int(Sk);
    for (int i = 0; i < 21; ++i) a.st[i] = strides[i];
    a.scale = scale;
    a.causal = causal;
    a.vec16 = bytes == 16;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && D == 128) return launch<float, 128>(which, a, B, s);
    if (dtype == 0 && D == 64) return launch<float, 64>(which, a, B, s);
    if (dtype == 1 && D == 128)
        return launch<__nv_bfloat16, 128>(which, a, B, s);
    if (dtype == 1 && D == 64)
        return launch<__nv_bfloat16, 64>(which, a, B, s);
    return int(cudaErrorInvalidValue);
}

}  // namespace

// The bytes of each cp.async of the q, k, v and do tiles that K2 and K3
// use for these pointers and (batch, head, seq) element strides (in the
// order q, k, v, do: 12 values): 16 when all four and every stride are
// 16-byte aligned, else 4; 0 when not even 4-byte aligned (the call is
// refused).  dtype 0 = float32, 1 = bfloat16.
extern "C" int bigdl_flash_bwd_copy_bytes(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const int64_t* strides, int dtype) {
    return copy_bytes4(q, k, v, dout, strides, dtype);
}

// q, dout: (B, H, Sq, D); k, v: (B, H, Sk, D); each with unit stride on D
// and the (batch, head, seq) element strides given in `strides`, in the
// order q, k, v, dout, dq, dk, dv (21 values).  lse and delta: contiguous
// (B, H, Sq) fp32.  dtype 0 = float32, 1 = bfloat16 (all of q, k, v, dout
// and the outputs); head_dim 64 or 128.  Each call launches one kernel on
// `stream`, does not synchronise, and returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unsupported dtype/head_dim,
// cudaErrorMisalignedAddress when q, k, v or dout is not 4-byte aligned).

// K2: writes dk and dv (dq is not touched and may be null).
extern "C" int bigdl_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int64_t B,
    int64_t H, int64_t Sq, int64_t Sk, int64_t D, const int64_t* strides,
    float sm_scale, int causal, int dtype, void* stream) {
    return dispatch(0, q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, Sq,
                    Sk, D, strides, sm_scale, causal, dtype, stream);
}

// K3: writes dq.
extern "C" int bigdl_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int64_t B, int64_t H,
    int64_t Sq, int64_t Sk, int64_t D, const int64_t* strides,
    float sm_scale, int causal, int dtype, void* stream) {
    return dispatch(1, q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H,
                    Sq, Sk, D, strides, sm_scale, causal, dtype, stream);
}
