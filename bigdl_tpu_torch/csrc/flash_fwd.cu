// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// (built by bigdl_tpu_torch/ops/_build.py, bound with ctypes in
// bigdl_tpu_torch/ops/flash_attention.py).
//
// Replaces: bigdl_tpu/ops/flash_attention.py:_fwd_kernel (via _fwd_pallas),
// the Pallas TPU kernel of the reference.  Same function: online-softmax
// attention over (B, H, S, D) with scores and accumulators in fp32, the
// finite mask value -0.7 * FLT_MAX for masked scores (so a row with no key
// to attend never computes exp(-inf - -inf) = NaN), l == 0 treated as 1,
// and outputs `out` (input dtype) and `lse = m + log(l)` (fp32).
//
// Design.  One block of 128 threads for each (batch*head, 64-row q tile);
// a loop inside the block walks the 64-key tiles (the TPU kernel's
// sequential grid axis becomes this loop).  Q is scaled by sm_scale as it
// is loaded, as the Pallas kernel does (_fwd_kernel scales q before the
// dot; the reference's blockwise path scales the scores after it — the
// two agree within fp32 rounding).  Q, K and V tiles are staged through
// shared memory as fp32 (bf16 inputs are widened on load); the score tile
// and the P·V product are fp32 FMAs on the CUDA cores.  Thread (ty, tx)
// owns q rows ty + 16*i (i < 4), key columns tx + 8*j of the score tile
// and head columns tx + 8*j of the output, so the row max and row sum are
// reduced over 8 neighbouring lanes with warp shuffles.  Q and K tiles use
// an odd row stride (D + 1) so that rows fall on distinct banks.
//
// Causal horizon: q position i attends k position j iff j <= i, positions
// counted from 0 in both (the reference's _block_causal_mask).  Key tiles
// wholly past the last real row of the q tile are skipped; the diagonal
// tile is always kept (n_kt = last_row / BK + 1).  The ragged tail (S not
// a multiple of the tile) is masked here, so there is no shape gate.
//
// What bounds it on an H100.  At the serving shape (B=8, H=6, S=512,
// D=128, causal, fp32) the work is ~3.2 GFLOP against ~50 MB of q/k/v/o
// traffic: operation-bound (~48 us at the 67 TFLOP/s fp32 non-tensor
// rate, ~15 us of memory at 3.35 TB/s).  This first kernel issues one
// shared-memory load for every ~2.7 FMAs, so shared-memory bandwidth, not
// the FMA pipe, is its limit; wgmma (bf16/tf32 tensor cores) and TMA
// staging are the way past it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // keys per tile
constexpr int NT = 128;         // threads per block
constexpr int TX = 8;           // lanes that share a q row
constexpr int TY = NT / TX;     // 16 row groups
constexpr int RPT = BQ / TY;    // 4 q rows per thread
constexpr int CPT = BK / TX;    // 8 score columns per thread
constexpr float MASK_VALUE = -0.7f * 3.402823466e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
    for (int off = 1; off < TX; off <<= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
    for (int off = 1; off < TX; off <<= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

template <int D>
constexpr size_t smem_bytes() {
    return sizeof(float) *
           (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D +
            size_t(BQ) * (BK + 1));
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
                 float sm_scale, int causal) {
    constexpr int DP = D + 1;       // odd row stride of the Q and K tiles
    constexpr int PP = BK + 1;      // row stride of the P tile
    constexpr int DPT = D / TX;     // output columns per thread
    extern __shared__ float smem[];
    float* sQ = smem;               // BQ x DP
    float* sK = sQ + BQ * DP;       // BK x DP
    float* sV = sK + BK * DP;       // BK x D
    float* sP = sV + BK * D;        // BQ x PP

    const int tid = threadIdx.x;
    const int tx = tid % TX;
    const int ty = tid / TX;
    const int q0 = blockIdx.x * BQ;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh % H;
    const T* qp = q + b * qsb + h * qsh;
    const T* kp = k + b * ksb + h * ksh;
    const T* vp = v + b * vsb + h * vsh;
    T* op = o + b * osb + h * osh;

    for (int idx = tid; idx < BQ * D; idx += NT) {
        const int r = idx / D, c = idx % D;
        const int row = q0 + r;
        sQ[r * DP + c] =
            row < Sq ? to_f32(qp[row * qss + c]) * sm_scale : 0.0f;
    }

    int n_kt = (Sk + BK - 1) / BK;
    if (causal) {
        const int last_row = min(q0 + BQ, Sq) - 1;
        n_kt = min(n_kt, last_row / BK + 1);
    }

    float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        m[i] = MASK_VALUE;
        l[i] = 0.0f;
#pragma unroll
        for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = 0.0f;
    }

    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();    // the previous tile's sK, sV and sP are read
        for (int idx = tid; idx < BK * D; idx += NT) {
            const int r = idx / D, c = idx % D;
            const int key = k0 + r;
            const bool in = key < Sk;
            sK[r * DP + c] = in ? to_f32(kp[key * kss + c]) : 0.0f;
            sV[r * D + c] = in ? to_f32(vp[key * vss + c]) : 0.0f;
        }
        __syncthreads();

        float s[RPT][CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < CPT; ++j) s[i][j] = 0.0f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
            float qv[RPT], kv[CPT];
#pragma unroll
            for (int i = 0; i < RPT; ++i) qv[i] = sQ[(ty + TY * i) * DP + d];
#pragma unroll
            for (int j = 0; j < CPT; ++j) kv[j] = sK[(tx + TX * j) * DP + d];
#pragma unroll
            for (int i = 0; i < RPT; ++i)
#pragma unroll
                for (int j = 0; j < CPT; ++j)
                    s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int qpos = q0 + ty + TY * i;
            float mx = MASK_VALUE;
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
                const int kpos = k0 + tx + TX * j;
                const bool ok = kpos < Sk && (!causal || qpos >= kpos);
                if (!ok) s[i][j] = MASK_VALUE;
                mx = fmaxf(mx, s[i][j]);
            }
            const float m_new = fmaxf(m[i], group_max(mx));
            const float corr = expf(m[i] - m_new);
            float rs = 0.0f;
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
                const float p = expf(s[i][j] - m_new);
                sP[(ty + TY * i) * PP + tx + TX * j] = p;
                rs += p;
            }
            l[i] = corr * l[i] + group_sum(rs);
            m[i] = m_new;
#pragma unroll
            for (int jd = 0; jd < DPT; ++jd) acc[i][jd] *= corr;
        }
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < BK; ++c) {
            float pv[RPT];
#pragma unroll
            for (int i = 0; i < RPT; ++i) pv[i] = sP[(ty + TY * i) * PP + c];
#pragma unroll
            for (int jd = 0; jd < DPT; ++jd) {
                const float vv = sV[c * D + tx + TX * jd];
#pragma unroll
                for (int i = 0; i < RPT; ++i)
                    acc[i][jd] = fmaf(pv[i], vv, acc[i][jd]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int row = q0 + ty + TY * i;
        if (row >= Sq) continue;
        const float safe_l = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
        for (int jd = 0; jd < DPT; ++jd)
            store(op + row * oss + tx + TX * jd, acc[i][jd] / safe_l);
        if (tx == 0) lse[int64_t(bh) * Sq + row] = m[i] + logf(safe_l);
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int64_t B, int64_t H, int64_t Sq, int64_t Sk,
                   const int64_t* st, float sm_scale, int causal,
                   cudaStream_t stream) {
    auto kernel = flash_fwd_kernel<T, D>;
    constexpr size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(unsigned((Sq + BQ - 1) / BQ), unsigned(B * H));
    kernel<<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), int(H), int(Sq), int(Sk),
        st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], st[11], sm_scale, causal);
    return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, H, S, D) with unit stride on D and the given (batch, head,
// seq) element strides; o likewise; lse: contiguous (B, H, Sq) fp32.
// dtype 0 = float32, 1 = bfloat16; head_dim 64 or 128.  Launches on
// `stream` and does not synchronise; returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unsupported dtype/head_dim).
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
    if (dtype == 0 && D == 128)
        return launch<float, 128>(q, k, v, o, lse, B, H, Sq, Sk, st,
                                  sm_scale, causal, s);
    if (dtype == 0 && D == 64)
        return launch<float, 64>(q, k, v, o, lse, B, H, Sq, Sk, st,
                                 sm_scale, causal, s);
    if (dtype == 1 && D == 128)
        return launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, H, Sq, Sk,
                                          st, sm_scale, causal, s);
    if (dtype == 1 && D == 64)
        return launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, H, Sq, Sk,
                                         st, sm_scale, causal, s);
    return int(cudaErrorInvalidValue);
}
