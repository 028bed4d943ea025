// Flash-attention backward for Hopper (sm_90a), with a plain C interface
// (built by bigdl_tpu_torch/ops/_build.py, bound with ctypes in
// bigdl_tpu_torch/ops/flash_attention.py).
//
// Replaces: bigdl_tpu/ops/flash_attention.py:_bwd_kernel_dkv (K2) and
// _bwd_kernel_dq (K3), the two Pallas TPU kernels of _bwd_pallas.  Same
// function and the same split:
//
//   K2 flash_bwd_dkv — one block per (64-key tile, batch*head); a loop
//      over the q tiles from the first one that can see the keys
//      (lo = k_start / BQ under causality) accumulates
//        dv += p^T do,   ds = p (do v^T - delta) scale,   dk += ds^T q.
//   K3 flash_bwd_dq  — one block per (64-row q tile, batch*head); a loop
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
// delta = sum_d do * out (fp32, one value per q row) is computed by the
// caller, as the reference leaves it to XLA.
//
// No atomics: every output element is written by exactly one block, which
// sums its terms in a fixed order, so the gradients are the same bits from
// run to run.
//
// Design.  256 threads; thread (ty, tx), 16 x 16.  In the 64 x 64 score
// tile a thread owns q rows ty + 16 i and key columns tx + 16 j (i, j < 4);
// in a 64 x D accumulator it owns rows ty + 16 i and head columns
// tx + 16 jd.  Tiles are staged through shared memory as fp32 (bf16 inputs
// are widened on load) with an odd row stride (D + 1) so that the 16 lanes
// reading 16 different rows fall on 16 banks.  Products are fp32 FMAs on
// the CUDA cores; outputs are written in the input dtype.  Inputs take any
// (batch, head, seq) strides with a unit stride on D, so the model's
// transposed views need no copy; the ragged tail of S is masked here, so
// there is no shape gate.
//
// What bounds it on an H100.  At the training shape (B=8, H=6, S=512,
// D=128, causal, fp32) K2 does 8 D FLOP per attended (q, k) pair, 6.5
// GFLOP, ~0.096 ms at the 67 TFLOP/s fp32 rate, against ~76 MB (~0.023 ms
// at 3.35 TB/s); K3 does 6 D per pair, 4.8 GFLOP, ~0.072 ms.  Both are
// operation-bound.  This first version issues one shared-memory load for
// every ~2.7 FMAs in its score loop and is limited by shared-memory
// bandwidth and by one 256-thread block per SM (165 KB of shared memory);
// wgmma on bf16/TF32 tiles with TMA staging is the way past it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NT = 256;         // threads per block
constexpr int TX = 16;
constexpr int TY = NT / TX;     // 16
constexpr int RPT = BQ / TY;    // 4 score rows per thread
constexpr int CPT = BK / TX;    // 4 score columns per thread
constexpr int KPT = BK / TY;    // 4 accumulator rows per thread (K2)
constexpr int PP = BK + 1;      // row stride of the p / ds tiles

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
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

// rows [r0, r0 + R) of a (seq, D) slice with row stride `ss`, widened to
// fp32 into a tile of row stride D + 1; rows at or past `n` read as 0
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t ss, int r0, int n) {
    for (int idx = threadIdx.x; idx < R * D; idx += NT) {
        const int r = idx / D, c = idx % D;
        const int row = r0 + r;
        dst[r * (D + 1) + c] = row < n ? to_f32(src[row * ss + c]) : 0.0f;
    }
}

// s = q k^T and dp = do v^T over one (q tile, key tile) pair, then
// p = exp(s * scale - lse) kept only where the pair is attended, and
// ds = p (dp - delta) scale.  Writes ds (and p when sP is given).
template <int D>
__device__ __forceinline__ void scores(const float* sQ, const float* sO,
                                       const float* sK, const float* sV,
                                       const float* sL, const float* sD,
                                       float* sP, float* sS, int q0, int k0,
                                       int Sq, int Sk, float scale,
                                       int causal) {
    constexpr int DP = D + 1;
    const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
        float qv[RPT], ov[RPT], kv[CPT], vv[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            qv[i] = sQ[(ty + TY * i) * DP + d];
            ov[i] = sO[(ty + TY * i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
            kv[j] = sK[(tx + TX * j) * DP + d];
            vv[j] = sV[(tx + TX * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
                s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
                dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
            }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = ty + TY * i;
        const int qpos = q0 + r;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
            const int c = tx + TX * j;
            const int kpos = k0 + c;
            const bool ok = qpos < Sq && kpos < Sk &&
                            (!causal || qpos >= kpos);
            const float e = expf(s[i][j] * scale - sL[r]);
            const float p = ok ? e : 0.0f;       // select after the exp
            if (sP) sP[r * PP + c] = p;
            sS[r * PP + c] = p * (dp[i][j] - sD[r]) * scale;
        }
    }
}

template <int D>
constexpr size_t dkv_smem() {
    return sizeof(float) * (size_t(2 * BK + 2 * BQ) * (D + 1) +
                            size_t(2 * BQ) * PP + 2 * BQ);
}

template <int D>
constexpr size_t dq_smem() {
    return sizeof(float) * (size_t(2 * BK + 2 * BQ) * (D + 1) +
                            size_t(BQ) * PP + 2 * BQ);
}

// K2: one block per (key tile, batch*head)
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(Args a) {
    constexpr int DP = D + 1;
    constexpr int DPT = D / TX;
    extern __shared__ float smem[];
    float* sK = smem;               // BK x DP
    float* sV = sK + BK * DP;       // BK x DP
    float* sQ = sV + BK * DP;       // BQ x DP
    float* sO = sQ + BQ * DP;       // do: BQ x DP
    float* sP = sO + BQ * DP;       // BQ x PP
    float* sS = sP + BQ * PP;       // ds: BQ x PP
    float* sL = sS + BQ * PP;       // lse: BQ
    float* sD = sL + BQ;            // delta: BQ

    const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
    const int k0 = blockIdx.x * BK;
    const int bh = blockIdx.y;
    const int b = bh / a.H, h = bh % a.H;
    const int64_t* st = a.st;
    const T* qp = static_cast<const T*>(a.q) + b * st[SQ] + h * st[SQ + 1];
    const T* kp = static_cast<const T*>(a.k) + b * st[SK] + h * st[SK + 1];
    const T* vp = static_cast<const T*>(a.v) + b * st[SV] + h * st[SV + 1];
    const T* op = static_cast<const T*>(a.dout) + b * st[SDO] +
                  h * st[SDO + 1];
    const float* lp = a.lse + int64_t(bh) * a.Sq;
    const float* dp = a.delta + int64_t(bh) * a.Sq;

    load_tile<T, D, BK>(sK, kp, st[SK + 2], k0, a.Sk);
    load_tile<T, D, BK>(sV, vp, st[SV + 2], k0, a.Sk);

    float dk[KPT][DPT], dv[KPT][DPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i)
#pragma unroll
        for (int jd = 0; jd < DPT; ++jd) dk[i][jd] = dv[i][jd] = 0.0f;

    const int n_qt = (a.Sq + BQ - 1) / BQ;
    const int lo = a.causal ? k0 / BQ : 0;
    for (int qt = lo; qt < n_qt; ++qt) {
        const int q0 = qt * BQ;
        __syncthreads();    // the previous tile's sQ, sO, sP, sS are read
        load_tile<T, D, BQ>(sQ, qp, st[SQ + 2], q0, a.Sq);
        load_tile<T, D, BQ>(sO, op, st[SDO + 2], q0, a.Sq);
        for (int r = threadIdx.x; r < BQ; r += NT) {
            const bool in = q0 + r < a.Sq;
            sL[r] = in ? lp[q0 + r] : 0.0f;
            sD[r] = in ? dp[q0 + r] : 0.0f;
        }
        __syncthreads();
        scores<D>(sQ, sO, sK, sV, sL, sD, sP, sS, q0, k0, a.Sq, a.Sk,
                  a.scale, a.causal);
        __syncthreads();
#pragma unroll 2
        for (int r = 0; r < BQ; ++r) {
            float pv[KPT], sv[KPT];
#pragma unroll
            for (int i = 0; i < KPT; ++i) {
                pv[i] = sP[r * PP + ty + TY * i];
                sv[i] = sS[r * PP + ty + TY * i];
            }
#pragma unroll
            for (int jd = 0; jd < DPT; ++jd) {
                const float ov = sO[r * DP + tx + TX * jd];
                const float qv = sQ[r * DP + tx + TX * jd];
#pragma unroll
                for (int i = 0; i < KPT; ++i) {
                    dv[i][jd] = fmaf(pv[i], ov, dv[i][jd]);
                    dk[i][jd] = fmaf(sv[i], qv, dk[i][jd]);
                }
            }
        }
    }

    T* dkp = static_cast<T*>(a.dk) + b * st[SDK] + h * st[SDK + 1];
    T* dvp = static_cast<T*>(a.dv) + b * st[SDV] + h * st[SDV + 1];
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
        const int key = k0 + ty + TY * i;
        if (key >= a.Sk) continue;
#pragma unroll
        for (int jd = 0; jd < DPT; ++jd) {
            const int c = tx + TX * jd;
            store(dkp + key * st[SDK + 2] + c, dk[i][jd]);
            store(dvp + key * st[SDV + 2] + c, dv[i][jd]);
        }
    }
}

// K3: one block per (q tile, batch*head)
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(Args a) {
    constexpr int DP = D + 1;
    constexpr int DPT = D / TX;
    extern __shared__ float smem[];
    float* sK = smem;               // BK x DP
    float* sV = sK + BK * DP;       // BK x DP
    float* sQ = sV + BK * DP;       // BQ x DP
    float* sO = sQ + BQ * DP;       // do: BQ x DP
    float* sS = sO + BQ * DP;       // ds: BQ x PP
    float* sL = sS + BQ * PP;       // lse: BQ
    float* sD = sL + BQ;            // delta: BQ

    const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
    const int q0 = blockIdx.x * BQ;
    const int bh = blockIdx.y;
    const int b = bh / a.H, h = bh % a.H;
    const int64_t* st = a.st;
    const T* qp = static_cast<const T*>(a.q) + b * st[SQ] + h * st[SQ + 1];
    const T* kp = static_cast<const T*>(a.k) + b * st[SK] + h * st[SK + 1];
    const T* vp = static_cast<const T*>(a.v) + b * st[SV] + h * st[SV + 1];
    const T* op = static_cast<const T*>(a.dout) + b * st[SDO] +
                  h * st[SDO + 1];
    const float* lp = a.lse + int64_t(bh) * a.Sq;
    const float* dp = a.delta + int64_t(bh) * a.Sq;

    load_tile<T, D, BQ>(sQ, qp, st[SQ + 2], q0, a.Sq);
    load_tile<T, D, BQ>(sO, op, st[SDO + 2], q0, a.Sq);
    for (int r = threadIdx.x; r < BQ; r += NT) {
        const bool in = q0 + r < a.Sq;
        sL[r] = in ? lp[q0 + r] : 0.0f;
        sD[r] = in ? dp[q0 + r] : 0.0f;
    }

    int n_kt = (a.Sk + BK - 1) / BK;
    if (a.causal) {
        const int last_row = min(q0 + BQ, a.Sq) - 1;
        n_kt = min(n_kt, last_row / BK + 1);
    }

    float dq[RPT][DPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int jd = 0; jd < DPT; ++jd) dq[i][jd] = 0.0f;

    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();    // the previous tile's sK, sV, sS are read
        load_tile<T, D, BK>(sK, kp, st[SK + 2], k0, a.Sk);
        load_tile<T, D, BK>(sV, vp, st[SV + 2], k0, a.Sk);
        __syncthreads();
        scores<D>(sQ, sO, sK, sV, sL, sD, nullptr, sS, q0, k0, a.Sq, a.Sk,
                  a.scale, a.causal);
        __syncthreads();
#pragma unroll 2
        for (int c = 0; c < BK; ++c) {
            float sv[RPT];
#pragma unroll
            for (int i = 0; i < RPT; ++i) sv[i] = sS[(ty + TY * i) * PP + c];
#pragma unroll
            for (int jd = 0; jd < DPT; ++jd) {
                const float kv = sK[c * DP + tx + TX * jd];
#pragma unroll
                for (int i = 0; i < RPT; ++i)
                    dq[i][jd] = fmaf(sv[i], kv, dq[i][jd]);
            }
        }
    }

    T* dqp = static_cast<T*>(a.dq) + b * st[SDQ] + h * st[SDQ + 1];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int row = q0 + ty + TY * i;
        if (row >= a.Sq) continue;
#pragma unroll
        for (int jd = 0; jd < DPT; ++jd)
            store(dqp + row * st[SDQ + 2] + tx + TX * jd, dq[i][jd]);
    }
}

template <typename T, int D>
cudaError_t launch(int which, const Args& a, int64_t B, cudaStream_t s) {
    const size_t smem = which == 0 ? dkv_smem<D>() : dq_smem<D>();
    auto kernel = which == 0 ? flash_bwd_dkv_kernel<T, D>
                             : flash_bwd_dq_kernel<T, D>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    const int n = which == 0 ? (a.Sk + BK - 1) / BK : (a.Sq + BQ - 1) / BQ;
    const dim3 grid(unsigned(n), unsigned(B * a.H));
    kernel<<<grid, NT, smem, s>>>(a);
    return cudaGetLastError();
}

int dispatch(int which, const void* q, const void* k, const void* v,
             const void* dout, const void* lse, const void* delta, void* dq,
             void* dk, void* dv, int64_t B, int64_t H, int64_t Sq,
             int64_t Sk, int64_t D, const int64_t* strides, float scale,
             int causal, int dtype, void* stream) {
    Args a;
    a.q = q; a.k = k; a.v = v; a.dout = dout;
    a.lse = static_cast<const float*>(lse);
    a.delta = static_cast<const float*>(delta);
    a.dq = dq; a.dk = dk; a.dv = dv;
    a.H = int(H); a.Sq = int(Sq); a.Sk = int(Sk);
    for (int i = 0; i < 21; ++i) a.st[i] = strides[i];
    a.scale = scale;
    a.causal = causal;
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

// q, dout: (B, H, Sq, D); k, v: (B, H, Sk, D); each with unit stride on D
// and the (batch, head, seq) element strides given in `strides`, in the
// order q, k, v, dout, dq, dk, dv (21 values).  lse and delta: contiguous
// (B, H, Sq) fp32.  dtype 0 = float32, 1 = bfloat16 (all of q, k, v, dout
// and the outputs); head_dim 64 or 128.  Each call launches one kernel on
// `stream`, does not synchronise, and returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unsupported dtype/head_dim).

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
