// Flash-attention forward for Hopper (sm_90a) on the tensor cores, with a
// plain C interface (built by bigdl_tpu_torch/ops/_build.py, bound with
// ctypes in bigdl_tpu_torch/ops/flash_attention.py).
//
// Replaces: bigdl_tpu/ops/flash_attention.py:_fwd_kernel (via _fwd_pallas),
// the Pallas TPU kernel of the reference.  Same function: online-softmax
// attention over (B, H, S, D) with scores and accumulators in fp32, the
// finite mask value -0.7 * FLT_MAX for masked scores (so a row with no key
// to attend never computes exp(-inf - -inf) = NaN), l == 0 treated as 1,
// and outputs `out` (input dtype) and `lse = m + log(l)` (fp32).
//
// Bounds on an H100 SXM.  At the main path's shape (B=8, H=6, S=512,
// D=128, causal, fp32) the attended pairs need 3.22 GFLOP against ~50 MB
// of q/k/v/out traffic.  The fp32 contract bounds it by operations: 48 us
// at the 67 TFLOP/s of the CUDA cores.  On the tensor cores the fp32
// contract costs three TF32 products for each one (below), so its floor
// there is 3 x 3.22 GFLOP / 495 TFLOP/s = 19.5 us; memory is ~15 us.
//
// Design (FlashAttention-2's shape, warp-level mma.sync):
//   * One block of 4 warps for each (batch*head, 64-row q tile); each warp
//     owns 16 q rows.  A loop inside the block walks the key tiles (the
//     TPU kernel's sequential grid axis).  Heavy causal tiles (high q) are
//     launched first.  The score tile S and the output accumulator O stay
//     in registers as MMA accumulator fragments; row max and row sum are
//     reduced over the 4 lanes of a quad with shuffles.  Nothing of S or P
//     goes through shared memory.
//   * f32: split TF32 on mma.m16n8k8.tf32.  Each operand x is split as
//     hi = tf32_rna(x), lo = x - hi (read by the MMA truncated to TF32),
//     and a product is lo*hi + hi*lo, then hi*hi, into the fp32
//     accumulator (lo*lo, ~2^-22 relative, is dropped): ~fp32 accuracy,
//     where one TF32 product alone misses the fp32 limit by 5x.  A split
//     costs 3 instructions (see split()).  Q is scaled by sm_scale in fp32
//     in shared memory, as the Pallas kernel scales it; Q, K and V stay
//     raw there and are split as their fragments are loaded.  (Q split
//     once into hi and lo tiles would need 132 KB at D=128, one block an
//     SM, and ran slower on an H100.)  Each of the three passes of a
//     product runs over several accumulators, so that no MMA waits on the
//     one before it.
//   * bf16: mma.m16n8k16.bf16.  Q.K^T of bf16 values has exact products
//     and fp32 sums; sm_scale is applied to S in fp32.  P stays fp32 as in
//     the reference: it is split into p_hi = bf16(p) and
//     p_lo = bf16(p - p_hi), two MMAs against the exact bf16 V.
//   * P from accumulator to A operand.  bf16: m16n8k16's accumulator
//     layout is its A layout (FlashAttention-2's register reuse).  f32:
//     m16n8k8.tf32 gives a thread accumulator columns (2t, 2t+1) but wants
//     A columns (t, t+4).  No shuffle: the contraction index is permuted
//     instead.  Per 8-key chunk, a0/a1 take accumulator column 2t and
//     a2/a3 column 2t+1, and the B fragment is read from V rows 2t (b0)
//     and 2t+1 (b1); the sum over keys does not depend on their order.
//   * K and V tiles are copied with cp.async into a two-stage ring, so
//     tile k+1 loads while tile k is computed.  Rows are padded (D + 4
//     floats, D + 8 bf16) so that every fragment load and ldmatrix is free
//     of bank conflicts.  The copy width is decided on the host for each
//     call: 16-byte cp.async.cg when q, k, v and all their strides are
//     16-byte aligned, 4-byte cp.async.ca otherwise.  Keys past Sk and q
//     rows past Sq are zero-filled in shared memory.  Q lands the same
//     way, with key tile 0.
//   * Masks as the reference: a key is attended iff k_pos < Sk and (not
//     causal or q_pos >= k_pos), positions from 0 in both; a masked score
//     takes MASK_VALUE by select before exp (tiles that no mask touches
//     skip the test).  Key tiles wholly past the last q row of a block are
//     skipped, and a warp skips the products of a tile wholly past its
//     own last row (exact: p would be 0 there).
//   * Dynamic shared memory: f32 D=128 (BK=32) 99 KB, f32 D=64 (BK=64)
//     85 KB, bf16 D=128 (BK=64) 85 KB, bf16 D=64 (BK=64) 45 KB: two blocks
//     (8 warps) an SM.
//
// What holds it back (H100, f32 at the main shape: level with PyTorch's
// SDPA, 37 % of the fp32 bound): latency.  Per key tile every warp splits
// each K and V fragment it loads, as do the other 3 warps of the block;
// those splits are most of the instructions that are not MMAs, and 8
// warps an SM cannot hide the MMAs' and loads' latency.  Left to a later
// PR: wgmma (warpgroup MMA) with TMA staging and warp specialisation,
// splitting each tile once.  For f32, wgmma TF32 wants both operands
// K-major, so P.V would need V transposed in shared memory, and it needs
// descriptors and swizzled layouts.
//
// ptxas -v (nvcc 12.9, sm_90a), registers: bf16 D=64 136, bf16 D=128 178,
// f32 D=64 168, f32 D=128 168; no instantiation spills (chip_smoke.py
// prints the build log and fails on a spill).
#include "flash_mma.cuh"

namespace {

using namespace fmma;

constexpr int BQ = 64;          // q rows per block
constexpr int NW = 4;           // warps per block, 16 q rows each
constexpr int NT = NW * 32;
constexpr float MASK_VALUE = -0.7f * 3.402823466e38f;

template <typename T, int D> struct Tile;
// keys per tile; row strides of the shared tiles, in elements
template <> struct Tile<float, 128> {
    static constexpr int BK = 32, DP = 132; };
template <> struct Tile<float, 64> {
    static constexpr int BK = 64, DP = 68; };
template <> struct Tile<__nv_bfloat16, 128> {
    static constexpr int BK = 64, DP = 136; };
template <> struct Tile<__nv_bfloat16, 64> {
    static constexpr int BK = 64, DP = 72; };

template <typename T, int D>
constexpr size_t smem_bytes() {
    constexpr int BK = Tile<T, D>::BK, DP = Tile<T, D>::DP;
    // Q once; K and V: two stages each
    return sizeof(T) * (size_t(BQ) * DP + size_t(4) * BK * DP);
}

// f32: the Q tile as it landed becomes Q * sm_scale, in place.  Each
// thread takes the elements it copied itself (copy_chunks' layout), which
// the wait that precedes this made visible to it.
template <int D, int E>
__device__ __forceinline__ void scale_q_chunks(float* sQ, float sm_scale) {
    constexpr int DP = Tile<float, D>::DP;
    constexpr int PER_ROW = D / E, STEP = NT / PER_ROW;
    const int r = threadIdx.x / PER_ROW, c = threadIdx.x % PER_ROW * E;
#pragma unroll 4
    for (int m = 0; m < BQ / STEP; ++m)
#pragma unroll
        for (int e = 0; e < E; ++e)
            sQ[(r + m * STEP) * DP + c + e] *= sm_scale;
}

template <int D>
__device__ __forceinline__ void scale_q(float* sQ, float sm_scale,
                                        bool vec16) {
    if (vec16)
        scale_q_chunks<D, 4>(sQ, sm_scale);
    else
        scale_q_chunks<D, 1>(sQ, sm_scale);
}

// S[16 x BK] of this warp: its q rows against the key tile.  f32: sQ holds
// Q * sm_scale, split as its fragments are loaded.
template <int D>
__device__ __forceinline__ void scores(float (*s)[4], const float* sQ,
                                       const float* sK, int w, int g, int t,
                                       float) {
    constexpr int BK = Tile<float, D>::BK, DP = Tile<float, D>::DP;
    const float* qr = sQ + (16 * w + g) * DP + t;
#pragma unroll 2
    for (int kc = 0; kc < D / 8; ++kc) {
        const int c = 8 * kc;
        const float a[4] = {qr[c], qr[8 * DP + c], qr[c + 4],
                            qr[8 * DP + c + 4]};
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) split(a[r], ahi[r], alo[r]);
        float kb[BK / 8][2];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
            const float* kr = sK + (8 * j + g) * DP + c + t;
            kb[j][0] = kr[0];
            kb[j][1] = kr[4];
        }
        mma_3xtf32<BK / 8>(s, ahi, alo, kb);
    }
}

template <int D>
__device__ __forceinline__ void scores(float (*s)[4],
                                       const __nv_bfloat16* sQ,
                                       const __nv_bfloat16* sK, int w,
                                       int g, int t, float sm_scale) {
    constexpr int BK = Tile<__nv_bfloat16, D>::BK;
    constexpr int DP = Tile<__nv_bfloat16, D>::DP;
    const __nv_bfloat16* qr = sQ + (16 * w + g) * DP + 2 * t;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
        const int c = 16 * kc;
        const uint32_t a[4] = {
            *reinterpret_cast<const uint32_t*>(qr + c),
            *reinterpret_cast<const uint32_t*>(qr + 8 * DP + c),
            *reinterpret_cast<const uint32_t*>(qr + c + 8),
            *reinterpret_cast<const uint32_t*>(qr + 8 * DP + c + 8)};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
            const __nv_bfloat16* kr = sK + (8 * j + g) * DP + c + 2 * t;
            mma_bf16(s[j], a, *reinterpret_cast<const uint32_t*>(kr),
                     *reinterpret_cast<const uint32_t*>(kr + 8));
        }
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= sm_scale;
}

// O[16 x D] += P[16 x BK] . V[BK x D]; P is this warp's S after exp.
template <int D>
__device__ __forceinline__ void accumulate_pv(float (*o)[4],
                                              float (*s)[4],
                                              const float* sV, int g,
                                              int t) {
    constexpr int BK = Tile<float, D>::BK, DP = Tile<float, D>::DP;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
        // permuted contraction: A column t <- key 2t, column t+4 <- key 2t+1
        uint32_t phi[4], plo[4];
        split(s[j][0], phi[0], plo[0]);
        split(s[j][2], phi[1], plo[1]);
        split(s[j][1], phi[2], plo[2]);
        split(s[j][3], phi[3], plo[3]);
        const float* vr = sV + (8 * j + 2 * t) * DP + g;
#pragma unroll
        for (int n0 = 0; n0 < D / 8; n0 += 8) {
            float vb[8][2];
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                vb[n][0] = vr[8 * (n0 + n)];
                vb[n][1] = vr[DP + 8 * (n0 + n)];
            }
            mma_3xtf32<8>(o + n0, phi, plo, vb);
        }
    }
}

template <int D>
__device__ __forceinline__ void accumulate_pv(float (*o)[4],
                                              float (*s)[4],
                                              const __nv_bfloat16* sV,
                                              int g, int t) {
    constexpr int BK = Tile<__nv_bfloat16, D>::BK;
    constexpr int DP = Tile<__nv_bfloat16, D>::DP;
    const int lane = threadIdx.x % 32;
    // ldmatrix row address of this lane: matrices (keys 0-7 | 8-15) x
    // (dims 0-7 | 8-15) of a 16 x 16 block
    const __nv_bfloat16* vl =
        sV + (lane % 8 + 8 * ((lane / 8) % 2)) * DP + 8 * (lane / 16);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
        const float* s0 = s[2 * kk];
        const float* s1 = s[2 * kk + 1];
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
                ldmatrix_x4_trans(b[n2], vl + 16 * kk * DP + 16 * (g4 + n2));
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

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Sk,
                 int64_t qsb, int64_t qsh, int64_t qss,
                 int64_t ksb, int64_t ksh, int64_t kss,
                 int64_t vsb, int64_t vsh, int64_t vss,
                 int64_t osb, int64_t osh, int64_t oss,
                 float sm_scale, int causal, int vec16) {
    constexpr int BK = Tile<T, D>::BK, DP = Tile<T, D>::DP;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sQ = reinterpret_cast<T*>(smem_raw);
    T* sK = sQ + BQ * DP;                       // 2 stages of BK x DP
    T* sV = sK + 2 * BK * DP;                   // 2 stages of BK x DP

    const int tid = threadIdx.x;
    const int w = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heavy tiles first
    const int bh = blockIdx.y;
    const int b = bh / H, h = bh % H;
    const T* qp = q + b * qsb + h * qsh;
    const T* kp = k + b * ksb + h * ksh;
    const T* vp = v + b * vsb + h * vsh;
    T* op = o + b * osb + h * osh;

    int n_kt = (Sk + BK - 1) / BK;
    if (causal) {
        const int last_row = min(q0 + BQ, Sq) - 1;
        n_kt = min(n_kt, last_row / BK + 1);
    }
    // the Q tile (rows past Sq as 0) and key tile 0: one group
    load_tile<T, D, DP, BQ, NT>(sQ, qp, qss, q0, Sq, vec16);
    load_tile<T, D, DP, BK, NT>(sK, kp, kss, 0, Sk, vec16);
    load_tile<T, D, DP, BK, NT>(sV, vp, vss, 0, Sk, vec16);
    cp_async_commit();

    // this warp's rows: g and g + 8 of its 16
    const int row0 = q0 + 16 * w + g;
    const int warp_last = min(q0 + 16 * w + 15, Sq - 1);
    float m[2] = {MASK_VALUE, MASK_VALUE}, l[2] = {0.0f, 0.0f};
    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

    for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt & 1;
        if (kt + 1 < n_kt) {
            const int nx = (kt + 1) & 1;
            load_tile<T, D, DP, BK, NT>(sK + nx * BK * DP, kp, kss,
                                        (kt + 1) * BK, Sk, vec16);
            load_tile<T, D, DP, BK, NT>(sV + nx * BK * DP, vp, vss,
                                        (kt + 1) * BK, Sk, vec16);
        }
        cp_async_commit();          // an empty group on the last tile
        cp_async_wait1();           // tile kt (and Q) landed: this thread's
        if constexpr (sizeof(T) == 4)
            if (kt == 0) scale_q<D>(sQ, sm_scale, vec16);
        __syncthreads();            // ... and every thread's

        const int k0 = kt * BK;
        // a warp whose rows all lie before this tile (causal), or past
        // Sq, would only add p = 0: skip its products
        if (row0 - g < Sq && !(causal && k0 > warp_last)) {
            float s[BK / 8][4];
#pragma unroll
            for (int j = 0; j < BK / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
            scores<D>(s, sQ, sK + st * BK * DP, w, g, t, sm_scale);

            // a tile before the causal diagonal of every row of the warp
            // and wholly inside Sk has nothing to mask
            const bool masked = k0 + BK > Sk ||
                                (causal && k0 + BK - 1 > row0 - g);
            float mx[2] = {MASK_VALUE, MASK_VALUE};
#pragma unroll
            for (int j = 0; j < BK / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int qpos = row0 + 8 * (e / 2);
                    const int kpos = k0 + 8 * j + 2 * t + e % 2;
                    if (masked && !(kpos < Sk && (!causal || qpos >= kpos)))
                        s[j][e] = MASK_VALUE;
                    mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
                }
            float corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const float m_new = fmaxf(m[r], quad_max(mx[r]));
                corr[r] = expf(m[r] - m_new);
                m[r] = m_new;
            }
#pragma unroll
            for (int j = 0; j < BK / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    s[j][e] = expf(s[j][e] - m[e / 2]);
                    rs[e / 2] += s[j][e];
                }
#pragma unroll
            for (int r = 0; r < 2; ++r)
                l[r] = corr[r] * l[r] + quad_sum(rs[r]);
#pragma unroll
            for (int n = 0; n < D / 8; ++n) {
                acc[n][0] *= corr[0];
                acc[n][1] *= corr[0];
                acc[n][2] *= corr[1];
                acc[n][3] *= corr[1];
            }
            accumulate_pv<D>(acc, s, sV + st * BK * DP, g, t);
        }
        __syncthreads();            // stage st is read: the next load may
    }                               // overwrite it

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= Sq) continue;
        const float safe_l = l[r] == 0.0f ? 1.0f : l[r];
        T* orow = op + row * oss + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
            store2(orow + 8 * n, acc[n][2 * r] / safe_l,
                   acc[n][2 * r + 1] / safe_l);
        if (t == 0) lse[int64_t(bh) * Sq + row] = m[r] + logf(safe_l);
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int64_t B, int64_t H, int64_t Sq, int64_t Sk,
                   const int64_t* st, float sm_scale, int causal, int vec16,
                   cudaStream_t stream) {
    auto kernel = flash_fwd_kernel<T, D>;
    constexpr size_t smem = smem_bytes<T, D>();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    // all of the SM's 228 KB as shared memory: two blocks of up to 110 KB
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return err;
    const dim3 grid(unsigned((Sq + BQ - 1) / BQ), unsigned(B * H));
    kernel<<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), int(H), int(Sq), int(Sk),
        st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], st[11], sm_scale, causal, vec16);
    return cudaGetLastError();
}

}  // namespace

// The bytes of each cp.async of the q, k and v tiles that bigdl_flash_fwd
// uses for these pointers and (batch, head, seq) element strides: 16 when
// q, k, v and all nine strides are 16-byte aligned, else 4; 0 when not
// even 4-byte aligned (the call is refused).  dtype 0 = float32,
// 1 = bfloat16.
extern "C" int bigdl_flash_fwd_copy_bytes(
    const void* q, const void* k, const void* v,
    int64_t qsb, int64_t qsh, int64_t qss,
    int64_t ksb, int64_t ksh, int64_t kss,
    int64_t vsb, int64_t vsh, int64_t vss, int dtype) {
    const void* ptrs[3] = {q, k, v};
    const int64_t st[3][3] = {{qsb, qsh, qss}, {ksb, ksh, kss},
                              {vsb, vsh, vss}};
    return fmma::copy_bytes(ptrs, st, 3, dtype == 0 ? 4 : 2);
}

// q, k, v: (B, H, S, D) with unit stride on D and the given (batch, head,
// seq) element strides; o likewise; lse: contiguous (B, H, Sq) fp32.
// dtype 0 = float32, 1 = bfloat16; head_dim 64 or 128.  Launches on
// `stream` and does not synchronise; returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unsupported dtype/head_dim,
// cudaErrorMisalignedAddress when q, k or v is not 4-byte aligned).
extern "C" int bigdl_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int64_t B, int64_t H, int64_t Sq, int64_t Sk, int64_t D,
    int64_t qsb, int64_t qsh, int64_t qss,
    int64_t ksb, int64_t ksh, int64_t kss,
    int64_t vsb, int64_t vsh, int64_t vss,
    int64_t osb, int64_t osh, int64_t oss,
    float sm_scale, int causal, int dtype, void* stream) {
    const int64_t st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                            vsb, vsh, vss, osb, osh, oss};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int bytes = bigdl_flash_fwd_copy_bytes(
        q, k, v, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, dtype);
    if (bytes == 0) return int(cudaErrorMisalignedAddress);
    const int vec16 = bytes == 16;
    if (dtype == 0 && D == 128)
        return launch<float, 128>(q, k, v, o, lse, B, H, Sq, Sk, st,
                                  sm_scale, causal, vec16, s);
    if (dtype == 0 && D == 64)
        return launch<float, 64>(q, k, v, o, lse, B, H, Sq, Sk, st,
                                 sm_scale, causal, vec16, s);
    if (dtype == 1 && D == 128)
        return launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, H, Sq, Sk,
                                          st, sm_scale, causal, vec16, s);
    if (dtype == 1 && D == 64)
        return launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, H, Sq, Sk,
                                         st, sm_scale, causal, vec16, s);
    return int(cudaErrorInvalidValue);
}
